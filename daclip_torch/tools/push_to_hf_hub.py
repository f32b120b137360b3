"""Push a trained checkpoint and its model config to the Hugging Face Hub.

Counterpart of `daclip_tpu/tools/push_to_hf_hub.py` (the reference's
open_clip/push_to_hf_hub.py: model card, config.json, weights). The upload
folder holds `config.json` ({"model_cfg", "model_name"}, the config from the
port's `get_model_config`), a model card naming daclip_torch, and a copy of
the checkpoint: a `.pt`/`.pth` or `.npz` file, or a directory such as the
port's restoration train dir (`<step>.pt`). `huggingface_hub` is imported
inside the call, and credentials come from its own configuration or
`token`.

  python -m daclip_torch.tools.push_to_hf_hub --checkpoint <file_or_dir> \\
      --model daclip_ViT-B-32 --repo-id user/daclip-vit-b-32
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

from daclip_torch.models.clip import get_model_config


def build_payload(checkpoint: str, model_name: str, out_dir: str) -> str:
    """Fill `out_dir` with config.json, the README model card and a copy of
    `checkpoint`; returns `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = {"model_cfg": get_model_config(model_name), "model_name": model_name}
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(f"---\ntags:\n- daclip-torch\n- image-restoration\n---\n"
                f"# {model_name}\n\nTrained with the daclip_torch framework "
                f"(PyTorch/CUDA rebuild of DA-CLIP).\n")
    dest = os.path.join(out_dir, os.path.basename(checkpoint.rstrip("/")))
    if not os.path.exists(dest):
        if os.path.isdir(checkpoint):
            shutil.copytree(checkpoint, dest)
        else:
            shutil.copy2(checkpoint, dest)
    return out_dir


def push_to_hf_hub(checkpoint: str, model_name: str, repo_id: str,
                   private: bool = False, token=None) -> str:
    """Create `repo_id` (if missing) and upload `build_payload`'s folder;
    returns the repo's URL."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise ImportError(
            "push_to_hf_hub requires the huggingface_hub package "
            "(`pip install huggingface_hub`)") from e
    api = HfApi(token=token)
    api.create_repo(repo_id, private=private, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        folder = build_payload(checkpoint, model_name, tmp)
        api.upload_folder(repo_id=repo_id, folder_path=folder)
    return f"https://huggingface.co/{repo_id}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--model", required=True)
    ap.add_argument("--repo-id", required=True)
    ap.add_argument("--private", action="store_true")
    args = ap.parse_args(argv)
    print(push_to_hf_hub(args.checkpoint, args.model, args.repo_id, args.private))


if __name__ == "__main__":
    main()
