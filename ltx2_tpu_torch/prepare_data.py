"""Prepare a fine-tuning dataset: pixels -> VAE latents -> latents.npz
(counterpart of scripts/prepare_data.py).

Each clip goes through the causal video VAE encoder (`encode_video`: its
output is already normalized by the per-channel statistics, the space the
denoise loop and the rectified-flow loss work in), is patchified to tokens
with the positions generation gives them (`VideoLatentTools`), and gets a
text context; the .npz holds x0 / positions / context, what
`python -m ltx2_tpu_torch.train --data` reads. The encoder's convs run on
the fp32 conv kernel on the card.

Pixel sources:
  --pixels clips.npz   array "pixels" (N, 3, F, H, W), float in [-1, 1] or
                       uint8 in [0, 255]; F is trimmed to 8k+1
  --images DIR         stills -> one-frame clips at --height x --width
                       (.png, .jpg, .jpeg and .webp, the JAX script's
                       suffixes, through the port's readers)
  --videos DIR         clips at --height x --width x --num-frames (snapped
                       to 8k+1): .y4m, MJPEG .avi/.mov/.mp4, .gif, .webp,
                       .apng and .png through the port's readers
                       (`read_video_any`), others through OpenCV or ffmpeg
                       when present
Context: --embedding emb.npz (its "positive" embedding, attached to every
clip; generate.py --save-embedding writes one) or --context-dim D (a zero
context of width D). Weights: --checkpoint (its VAE encoder) or
--placeholder (the full-width encoder, random weights from a fixed seed).

    python -m ltx2_tpu_torch.prepare_data --pixels clips.npz --checkpoint ltx-2.safetensors \\
        --embedding prompt.npz --output latents.npz
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoder, encode_video
from ltx2_tpu_torch.pipelines.common import load_image_tensor
from ltx2_tpu_torch.types import VideoLatentShape

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".webp")
VIDEO_SUFFIXES = (".gif", ".webp", ".apng", ".y4m", ".avi", ".mp4", ".webm", ".mov")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pixels", type=str, default=None, help=".npz with 'pixels' (N, 3, F, H, W)")
    p.add_argument("--images", type=str, default=None, help="directory of images -> one-frame clips")
    p.add_argument("--videos", type=str, default=None,
                   help="directory of video clips: .y4m, MJPEG .avi/.mov/.mp4, .gif, .webp and .apng decode "
                        "without ffmpeg; other codecs through OpenCV or ffmpeg when present")
    p.add_argument("--num-frames", type=int, default=9, help="frames per clip for --videos (snapped to 8k+1)")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--placeholder", action="store_true", help="random-weight encoder (smoke runs)")
    p.add_argument("--embedding", type=str, default=None, help="generate.py --save-embedding npz (shared context)")
    p.add_argument("--context-dim", type=int, default=None, help="zero context of this width instead of --embedding")
    p.add_argument("--fps", type=float, default=24.0)
    p.add_argument("--output", type=str, default="latents.npz")
    p.add_argument("--device", default=None, help="default: cuda")
    return p


def _log(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def load_encoder(args, device: torch.device) -> VideoEncoder:
    """The checkpoint's VAE encoder, else the full-width one with random
    weights (generate.make_encoder's seed)."""
    if args.checkpoint and not args.placeholder:
        from ltx2_tpu_torch.utils.model_ledger import ModelLedger

        return ModelLedger(checkpoint_path=args.checkpoint, device=device).video_encoder()
    from ltx2_tpu_torch.generate import make_encoder

    return make_encoder(device)


def load_clips(args) -> List[np.ndarray]:
    """Each clip as float32 (1, 3, F, H, W) in [-1, 1]."""
    if args.pixels:
        data = np.load(args.pixels)["pixels"]
        if data.dtype == np.uint8:
            data = data.astype(np.float32) / 127.5 - 1.0
        f = data.shape[2]
        snapped = f - (f - 1) % 8  # the causal VAE's temporal stride needs 8k+1 frames
        if snapped != f:
            _log({"note": f"--pixels clips have {f} frames; trimmed to {snapped}"})
            data = data[:, :, :snapped]
        return [np.asarray(data[i: i + 1], np.float32) for i in range(data.shape[0])]
    if args.images:
        paths = sorted(q for q in Path(args.images).iterdir() if q.suffix.lower() in IMAGE_SUFFIXES)
        return [load_image_tensor(str(q), args.height, args.width).numpy() for q in paths]
    if args.videos:
        from ltx2_tpu_torch.utils.video_io import read_video_any

        n_frames = args.num_frames - (args.num_frames - 1) % 8  # 8k + 1
        paths = sorted(q for q in Path(args.videos).iterdir() if q.suffix.lower() in VIDEO_SUFFIXES)
        return [read_video_any(str(q), args.height, args.width, n_frames) for q in paths]
    return []


def encode_clip(encoder: VideoEncoder, clip: np.ndarray, fps: float, device: torch.device):
    """(tokens (1, N, C), positions (1, 3, N, 2)) of one clip, fp32 numpy:
    the encoder's normalized latent patchified, positions as generation
    makes them."""
    with torch.no_grad():
        latent = encode_video(torch.from_numpy(clip).to(device), encoder)
    patchifier = VideoLatentPatchifier(patch_size=1)
    tools = VideoLatentTools(patchifier=patchifier, target_shape=VideoLatentShape(*latent.shape), fps=fps)
    positions = tools.create_initial_state(device=device).positions
    tokens = patchifier.patchify(latent)
    return tokens.float().cpu().numpy(), positions.float().cpu().numpy()


def main(argv=None, encoder: Optional[VideoEncoder] = None) -> dict:
    """Write the dataset per the flags; returns {"x0", "positions",
    "context", "encode_s"} (the arrays written, each clip's seconds).
    `encoder` replaces the one the flags name."""
    args = build_parser().parse_args(argv)
    clips = load_clips(args)
    if not clips:
        raise SystemExit("pass --pixels clips.npz, --images DIR or --videos DIR")
    if not (args.embedding or args.context_dim):
        raise SystemExit("pass --embedding emb.npz or --context-dim D")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if encoder is None:
        encoder = load_encoder(args, device)
    x0s, poss, encode_s = [], [], []
    for clip in clips:
        t0 = time.perf_counter()
        tokens, positions = encode_clip(encoder, clip, args.fps, device)  # .cpu() waited for the device
        encode_s.append(time.perf_counter() - t0)
        x0s.append(tokens)
        poss.append(positions)
    x0, positions = np.concatenate(x0s, axis=0), np.concatenate(poss, axis=0)
    n = x0.shape[0]
    if args.embedding:
        context = np.repeat(np.load(args.embedding)["positive"].astype(np.float32), n, axis=0)
    else:
        context = np.zeros((n, 1, args.context_dim), np.float32)
    np.savez(args.output, x0=x0, positions=positions, context=context)
    _log({"wrote": args.output, "x0": list(x0.shape), "positions": list(positions.shape),
          "context": list(context.shape), "encode_s": encode_s})
    return {"x0": x0, "positions": positions, "context": context, "encode_s": encode_s}


if __name__ == "__main__":
    main()
