"""Generation snapshots (counterpart of ltx2_tpu/utils/checkpointing.py).

A generation's denoising state is its `LatentState` and its place in the
sigma schedule: saved after any stage or step, reloaded, and continued with
`sigmas[step:]` (the Euler loop depends only on the latent and the sigma).
The npz holds the JAX package's keys (`video_latent`, `video_denoise_mask`,
`video_positions`, `video_clean_latent`, the same under `audio_`, `sigmas`,
`step`), so a snapshot written by either package loads in the other. The
GE velocity momentum (`ge_gamma`) is not saved: it restarts at a resume.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.types import LatentState

_FIELDS = ("latent", "denoise_mask", "positions", "clean_latent")


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_generation_state(path: str, state: LatentState, sigmas, step: int,
                          audio_state: Optional[LatentState] = None) -> None:
    """Write a snapshot to `path` (exactly that path: the file is written
    through a handle, so no '.npz' is appended): the state(s), the whole
    sigma schedule (float32) and the steps taken (int32). A bf16 latent is
    saved as float32."""
    payload = {f"video_{k}": _host(getattr(state, k)) for k in _FIELDS}
    if audio_state is not None:
        payload.update({f"audio_{k}": _host(getattr(audio_state, k)) for k in _FIELDS})
    payload["sigmas"] = np.asarray(sigmas.cpu() if isinstance(sigmas, torch.Tensor) else sigmas, np.float32)
    payload["step"] = np.int32(step)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)


def load_generation_state(path: str, device=None
                          ) -> Tuple[LatentState, Optional[LatentState], torch.Tensor, int]:
    """A snapshot -> (video state, audio state or None, the sigmas from the
    saved step on, step), the tensors on `device` (default the CPU), so
    `loop(model, state, remaining_sigmas, ...)` continues the run."""
    with np.load(path) as data:
        def build(prefix: str) -> Optional[LatentState]:
            if f"{prefix}_latent" not in data:
                return None
            return LatentState(**{k: torch.from_numpy(np.array(data[f"{prefix}_{k}"])).to(device) for k in _FIELDS})

        step = int(data["step"])
        sigmas = torch.from_numpy(np.array(data["sigmas"])).to(device)
        return build("video"), build("audio"), sigmas[step:], step
