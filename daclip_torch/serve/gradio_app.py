"""The Gradio demo — config/daclip-sde/app.py:44-62 (ViT-B-32) and
config/wild-ir/app.py (ViT-L-14, `--wild-ir`).

Counterpart of `daclip_tpu/serve/gradio_app.py:14-61`, plus `--device`
(default cuda). gradio is imported in the calls; without it `main` exits
with daclip_tpu's message.

  python -m daclip_torch.serve.gradio_app --unet ... --daclip ... [--wild-ir]
"""
from __future__ import annotations

import argparse

import numpy as np


def build_app(restorer):
    """A gradio Interface whose handler takes an RGB uint8 image and returns
    (the restored RGB uint8 image, the degradation's name)."""
    import gradio as gr

    def restore(image):
        rgb = np.asarray(image).astype(np.float32) / 255.0
        name, _ = restorer.classify_degradation(rgb)
        out_bgr = restorer.restore(rgb)
        return out_bgr[:, :, ::-1], name

    return gr.Interface(
        fn=restore,
        inputs=[gr.Image(label="Input (degraded)")],
        outputs=[gr.Image(label="Restored"), gr.Text(label="Degradation")],
        title="DA-CLIP Universal Image Restoration",
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--unet", required=True, help="torch .pth or .npz")
    p.add_argument("--daclip", required=True, help="torch .pt or .npz")
    p.add_argument("--wild-ir", action="store_true")
    p.add_argument("--sample-T", type=int, default=-1,
                   help="sampler steps (< T trades quality for latency)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    args = p.parse_args(argv)

    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit("gradio is not installed in this environment; "
                         "use daclip_torch.cli.predict or serve.predictor instead")

    from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig

    cfg = RestorerConfig(sample_T=args.sample_T)
    if args.wild_ir:
        cfg = RestorerConfig(model_name="daclip_ViT-L-14", context_dim=768, scale=0.5,
                             sample_T=args.sample_T)
    restorer = DACLIPRestorer.load(args.unet, args.daclip, cfg, device=args.device)
    build_app(restorer).launch(server_port=args.port)


if __name__ == "__main__":
    main()
