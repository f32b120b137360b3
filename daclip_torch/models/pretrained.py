"""The pretrained-weights registry, and its cached, sha256-checked download.

Counterpart of `daclip_tpu/models/pretrained.py:22-278` (reference
universal-image-restoration/open_clip/pretrained.py:227-426): the `_PRETRAINED`
tag table (a copy of daclip_tpu's), the lookups, the URL download through a
`.part` file checked by sha256 into `~/.cache/clip`, and the HF-hub path
(`huggingface_hub` is imported in the call). The factory loads the file it
returns as any local `.pt`.
"""
from __future__ import annotations

import hashlib
import os
import urllib.request
import warnings
from typing import Dict, Optional


def _pcfg(url: str = "", hf_hub: str = "", mean=None, std=None) -> Dict:
    return {"url": url, "hf_hub": hf_hub, "mean": mean, "std": std}


_OPENAI = "https://openaipublic.azureedge.net/clip/models"
_MLF = "https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights"


def _pool_tags(model_slug: str, pool: str, suffix: str) -> Dict[str, Dict]:
    """DataComp/CommonPool tag families (pretrained.py:88-104,120-128,145-150):
    one DataComp tag + the CommonPool filtering ablations for a scale."""
    tags = {f"datacomp_{pool}_{suffix}".replace("-", "_").lower():
            _pcfg(hf_hub=f"laion/CLIP-{model_slug}-DataComp.{pool.upper()}-{suffix}/")}
    variants = ["clip", "laion", "image", "text", "basic", ""] \
        if pool != "xl" else ["clip", "laion", ""]
    for v in variants:
        dotted = f"CommonPool.{pool.upper()}" + (f".{v}" if v else "")
        tag = f"commonpool_{pool}" + (f"_{v}" if v else "") + f"_{suffix}"
        tags[tag.replace("-", "_").lower()] = \
            _pcfg(hf_hub=f"laion/CLIP-{model_slug}-{dotted}-{suffix}/")
    return tags


# Full reference tag table (open_clip/pretrained.py:30-283): every model
# family and tag, including quickgelu twins, DataComp/CommonPool ablations,
# convnext / EVA / CoCa / HF-text releases.  URLs and hub ids are public
# release facts.
_OPENAI_URLS = {
    "RN50": f"{_OPENAI}/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": f"{_OPENAI}/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": f"{_OPENAI}/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": f"{_OPENAI}/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": f"{_OPENAI}/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B-32": f"{_OPENAI}/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B-16": f"{_OPENAI}/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L-14": f"{_OPENAI}/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L-14-336": f"{_OPENAI}/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}

_RN50_TAGS = {
    "openai": _pcfg(_OPENAI_URLS["RN50"]),
    "yfcc15m": _pcfg(f"{_MLF}/rn50-quickgelu-yfcc15m-455df137.pt"),
    "cc12m": _pcfg(f"{_MLF}/rn50-quickgelu-cc12m-f000538c.pt"),
}
_RN101_TAGS = {
    "openai": _pcfg(_OPENAI_URLS["RN101"]),
    "yfcc15m": _pcfg(f"{_MLF}/rn101-quickgelu-yfcc15m-3e04b30e.pt"),
}
_VITB32_QG_TAGS = {
    "openai": _pcfg(_OPENAI_URLS["ViT-B-32"]),
    "laion400m_e31": _pcfg(f"{_MLF}/vit_b_32-quickgelu-laion400m_e31-d867053b.pt"),
    "laion400m_e32": _pcfg(f"{_MLF}/vit_b_32-quickgelu-laion400m_e32-46683a32.pt"),
}

_PRETRAINED: Dict[str, Dict[str, Dict]] = {
    "RN50": dict(_RN50_TAGS),
    "RN50-quickgelu": dict(_RN50_TAGS),
    "RN101": dict(_RN101_TAGS),
    "RN101-quickgelu": dict(_RN101_TAGS),
    "RN50x4": {"openai": _pcfg(_OPENAI_URLS["RN50x4"])},
    "RN50x16": {"openai": _pcfg(_OPENAI_URLS["RN50x16"])},
    "RN50x64": {"openai": _pcfg(_OPENAI_URLS["RN50x64"])},
    "ViT-B-32": {
        **_VITB32_QG_TAGS,
        "laion2b_e16": _pcfg(f"{_MLF}/vit_b_32-laion2b_e16-af8dbd0c.pth"),
        "laion2b_s34b_b79k": _pcfg(hf_hub="laion/CLIP-ViT-B-32-laion2B-s34B-b79K/"),
        **_pool_tags("ViT-B-32", "m", "s128M-b4K"),
        **_pool_tags("ViT-B-32", "s", "s13M-b4K"),
    },
    "ViT-B-32-quickgelu": dict(_VITB32_QG_TAGS),
    "ViT-B-16": {
        "openai": _pcfg(_OPENAI_URLS["ViT-B-16"]),
        "laion400m_e31": _pcfg(f"{_MLF}/vit_b_16-laion400m_e31-00efa78f.pt"),
        "laion400m_e32": _pcfg(f"{_MLF}/vit_b_16-laion400m_e32-55e67d44.pt"),
        "laion2b_s34b_b88k": _pcfg(hf_hub="laion/CLIP-ViT-B-16-laion2B-s34B-b88K/"),
        **_pool_tags("ViT-B-16", "l", "s1B-b8K"),
    },
    "ViT-B-16-plus-240": {
        "laion400m_e31": _pcfg(f"{_MLF}/vit_b_16_plus_240-laion400m_e31-8fb26589.pt"),
        "laion400m_e32": _pcfg(f"{_MLF}/vit_b_16_plus_240-laion400m_e32-699c4b84.pt"),
    },
    "ViT-L-14": {
        "openai": _pcfg(_OPENAI_URLS["ViT-L-14"]),
        "laion400m_e31": _pcfg(f"{_MLF}/vit_l_14-laion400m_e31-69988bb6.pt"),
        "laion400m_e32": _pcfg(f"{_MLF}/vit_l_14-laion400m_e32-3d133497.pt"),
        "laion2b_s32b_b82k": _pcfg(hf_hub="laion/CLIP-ViT-L-14-laion2B-s32B-b82K/",
                                   mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
        **_pool_tags("ViT-L-14", "xl", "s13B-b90K"),
    },
    "ViT-L-14-336": {"openai": _pcfg(_OPENAI_URLS["ViT-L-14-336"])},
    "ViT-H-14": {
        "laion2b_s32b_b79k": _pcfg(hf_hub="laion/CLIP-ViT-H-14-laion2B-s32B-b79K/")},
    "ViT-g-14": {
        "laion2b_s12b_b42k": _pcfg(hf_hub="laion/CLIP-ViT-g-14-laion2B-s12B-b42K/"),
        "laion2b_s34b_b88k": _pcfg(hf_hub="laion/CLIP-ViT-g-14-laion2B-s34B-b88K/"),
    },
    "ViT-bigG-14": {
        "laion2b_s39b_b160k": _pcfg(hf_hub="laion/CLIP-ViT-bigG-14-laion2B-39B-b160k/")},
    "roberta-ViT-B-32": {
        "laion2b_s12b_b32k": _pcfg(hf_hub="laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k/")},
    "xlm-roberta-base-ViT-B-32": {
        "laion5b_s13b_b90k": _pcfg(hf_hub="laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k/")},
    "xlm-roberta-large-ViT-H-14": {
        "frozen_laion5b_s13b_b90k": _pcfg(hf_hub="laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k/")},
    "convnext_base": {
        "laion400m_s13b_b51k": _pcfg(hf_hub="laion/CLIP-convnext_base-laion400M-s13B-b51K/")},
    "convnext_base_w": {
        "laion2b_s13b_b82k": _pcfg(hf_hub="laion/CLIP-convnext_base_w-laion2B-s13B-b82K/"),
        "laion2b_s13b_b82k_augreg": _pcfg(hf_hub="laion/CLIP-convnext_base_w-laion2B-s13B-b82K-augreg/"),
        "laion_aesthetic_s13b_b82k": _pcfg(hf_hub="laion/CLIP-convnext_base_w-laion_aesthetic-s13B-b82K/"),
    },
    "convnext_base_w_320": {
        "laion_aesthetic_s13b_b82k": _pcfg(hf_hub="laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K/"),
        "laion_aesthetic_s13b_b82k_augreg": _pcfg(hf_hub="laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K-augreg/"),
    },
    "convnext_large_d": {
        "laion2b_s26b_b102k_augreg": _pcfg(hf_hub="laion/CLIP-convnext_large_d.laion2B-s26B-b102K-augreg/")},
    "convnext_large_d_320": {
        "laion2b_s29b_b131k_ft": _pcfg(hf_hub="laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft/"),
        "laion2b_s29b_b131k_ft_soup": _pcfg(hf_hub="laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft-soup/"),
    },
    "convnext_xxlarge": {
        "laion2b_s34b_b82k_augreg": _pcfg(hf_hub="laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg/"),
        "laion2b_s34b_b82k_augreg_rewind": _pcfg(hf_hub="laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-rewind/"),
        "laion2b_s34b_b82k_augreg_soup": _pcfg(hf_hub="laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-soup/"),
    },
    "coca_ViT-B-32": {
        "laion2b_s13b_b90k": _pcfg(hf_hub="laion/CoCa-ViT-B-32-laion2B-s13B-b90k/"),
        "mscoco_finetuned_laion2b_s13b_b90k": _pcfg(hf_hub="laion/mscoco_finetuned_CoCa-ViT-B-32-laion2B-s13B-b90k/"),
    },
    "coca_ViT-L-14": {
        "laion2b_s13b_b90k": _pcfg(hf_hub="laion/CoCa-ViT-L-14-laion2B-s13B-b90k/"),
        "mscoco_finetuned_laion2b_s13b_b90k": _pcfg(hf_hub="laion/mscoco_finetuned_CoCa-ViT-L-14-laion2B-s13B-b90k/"),
    },
    "EVA01-g-14": {
        "laion400m_s11b_b41k": _pcfg(hf_hub="timm/eva_giant_patch14_clip_224.laion400m_s11b_b41k/")},
    "EVA01-g-14-plus": {
        "merged2b_s11b_b114k": _pcfg(hf_hub="timm/eva_giant_patch14_plus_clip_224.merged2b_s11b_b114k/")},
    "EVA02-B-16": {
        "merged2b_s8b_b131k": _pcfg(hf_hub="timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k/")},
    "EVA02-L-14": {
        "merged2b_s4b_b131k": _pcfg(hf_hub="timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k/")},
    "EVA02-L-14-336": {
        "merged2b_s6b_b61k": _pcfg(hf_hub="timm/eva02_large_patch14_clip_336.merged2b_s6b_b61k/")},
    "EVA02-E-14": {
        "laion2b_s4b_b115k": _pcfg(hf_hub="timm/eva02_enormous_patch14_clip_224.laion2b_s4b_b115k/")},
    "EVA02-E-14-plus": {
        "laion2b_s9b_b144k": _pcfg(hf_hub="timm/eva02_enormous_patch14_plus_clip_224.laion2b_s9b_b144k/")},
}


def _clean_tag(tag: str) -> str:
    return tag.lower().replace("-", "_")


def list_pretrained(as_str: bool = False):
    return [":".join([k, t]) if as_str else (k, t)
            for k in _PRETRAINED for t in _PRETRAINED[k]]


def list_pretrained_tags_by_model(model: str):
    # daclip_* names resolve tags through the underlying tower
    # (open_clip/factory.py:225-227 strips the prefix before tag lookup)
    model = model.replace("daclip_", "")
    return list(_PRETRAINED.get(model, {}).keys())


def is_pretrained_cfg(model: str, tag: str) -> bool:
    model = model.replace("daclip_", "")
    return _clean_tag(tag) in _PRETRAINED.get(model, {})


def get_pretrained_cfg(model: str, tag: str) -> Dict:
    model = model.replace("daclip_", "")
    return dict(_PRETRAINED.get(model, {}).get(_clean_tag(tag), {}))


def get_pretrained_url(model: str, tag: str) -> str:
    return get_pretrained_cfg(model, tag).get("url", "")


def _expected_sha256(url: str) -> str:
    filename = os.path.basename(url)
    if "openaipublic" in url:
        return url.split("/")[-2]
    if "mlfoundations" in url:
        return os.path.splitext(filename)[0].split("-")[-1]
    return ""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_pretrained_from_url(url: str,
                                 cache_dir: Optional[str] = None) -> str:
    """sha256-verified cached download (pretrained.py:334-380).  Raises
    URLError in egress-free environments — callers should point `pretrained`
    at a local file instead.  Downloads go to a temp file and are renamed into
    the cache only after (verified) completion, so an interrupted transfer
    never poisons the cache."""
    if not cache_dir:
        cache_dir = os.path.expanduser("~/.cache/clip")
    os.makedirs(cache_dir, exist_ok=True)
    filename = os.path.basename(url)
    expected = _expected_sha256(url)
    target = os.path.join(cache_dir, filename)
    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if not expected:
            return target
        if _sha256_file(target).startswith(expected):
            return target
        warnings.warn(f"{target} exists but sha256 mismatches; re-downloading")
    tmp = target + ".part"
    try:
        with urllib.request.urlopen(url) as src, open(tmp, "wb") as out:
            while True:
                buf = src.read(1 << 20)
                if not buf:
                    break
                out.write(buf)
        if expected and not _sha256_file(tmp).startswith(expected):
            raise RuntimeError("downloaded checkpoint fails sha256 verification")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def download_pretrained(cfg: Dict, cache_dir: Optional[str] = None) -> str:
    """pretrained.py:400-426: URL first, HF-hub fallback."""
    if not cfg:
        return ""
    if cfg.get("url"):
        return download_pretrained_from_url(cfg["url"], cache_dir=cache_dir)
    if cfg.get("hf_hub"):
        try:
            from huggingface_hub import hf_hub_download
        except ImportError as e:
            raise RuntimeError(
                "HF-hub pretrained tag requested but huggingface_hub is not "
                "installed; download the checkpoint manually and pass its "
                "local path as `pretrained`") from e
        parts = cfg["hf_hub"].rstrip("/").split("/")
        if len(parts) > 2:  # 'org/model/filename.pt' form (pretrained.py:419-424)
            model_id, filename = "/".join(parts[:2]), parts[2]
        else:
            model_id, filename = "/".join(parts), "open_clip_pytorch_model.bin"
        return hf_hub_download(model_id, filename, cache_dir=cache_dir)
    return ""
