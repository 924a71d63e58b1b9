"""Temporal-chunked decoding with crossfade blending (counterpart of
ltx2_tpu/models/video_vae/chunking.py): overlapping latent-frame chunks
blended with a linear ramp, then [-1, 1] -> uint8 (T, H, W, 3) frames.
Chunking bounds the decoder's peak memory on long clips."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, video_decoder_apply


def _to_uint8_frames(video: torch.Tensor) -> torch.Tensor:
    """[-1, 1] (B, 3, T, H, W) -> uint8 (T, H, W, 3) of batch 0, on the
    video's device. The cast truncates, as the JAX package's does."""
    video = ((video + 1) / 2).clamp(0, 1) * 255
    return video.to(torch.uint8)[0].permute(1, 2, 3, 0)


def latent_t_to_pixel_t(lt: int, num_temporal_upsamples: int = 3) -> int:
    """Latent frames -> pixel frames (each temporal upsample: t -> 2t - 1)."""
    pt = lt
    for _ in range(num_temporal_upsamples):
        pt = pt * 2 - 1
    return pt


@torch.no_grad()
def decode_latent(
    latent: torch.Tensor,
    decoder: VideoDecoder,
    timestep: Optional[float] = 0.05,
    generator: Optional[torch.Generator] = None,
    temporal_chunk_size: int = 0,
    temporal_overlap: int = 2,
    causal: bool = False,
) -> np.ndarray:
    """Decode one clip's latent (1, 128, T, H, W) -> uint8 (T', H', W', 3)
    frames on the host.

    Decode noise for each chunk is drawn from `generator` (default: a fresh
    generator seeded 0 on the latent's device, as the JAX package defaults
    to PRNGKey(0)). temporal_chunk_size=0 decodes in one pass."""
    if latent.ndim == 4:
        latent = latent[None]
    if latent.shape[0] != 1:
        raise ValueError(f"decode_latent decodes ONE clip (got batch {latent.shape[0]}); loop per clip")
    if 0 < temporal_chunk_size <= temporal_overlap:
        raise ValueError(
            f"temporal_chunk_size ({temporal_chunk_size}) must exceed temporal_overlap ({temporal_overlap})"
        )
    if generator is None:
        generator = torch.Generator(device=latent.device).manual_seed(0)

    def decode(chunk: torch.Tensor) -> torch.Tensor:
        noise = torch.randn(chunk.shape, generator=generator, dtype=torch.float32, device=chunk.device)
        return video_decoder_apply(decoder, chunk, timestep=timestep, noise=noise, causal=causal)

    t_latent = latent.shape[2]
    chunks = temporal_chunks(t_latent, temporal_chunk_size, temporal_overlap)
    if len(chunks) == 1:
        video = decode(latent)
    else:
        n_up = decoder.cfg.num_temporal_upsamples
        total_pixel_frames = latent_t_to_pixel_t(t_latent, n_up)
        overlap_pixel_ref = latent_t_to_pixel_t(temporal_overlap, n_up)
        video = None
        for t, end in chunks:
            cur = decode(latent[:, :, t:end])
            if video is None:
                video = cur
            else:
                overlap = min(overlap_pixel_ref, cur.shape[2], video.shape[2])
                if overlap <= 1:
                    video = torch.cat([video, cur], dim=2)
                else:
                    ramp = torch.linspace(0.0, 1.0, overlap, device=cur.device).view(1, 1, -1, 1, 1)
                    blended = video[:, :, -overlap:] * (1.0 - ramp) + cur[:, :, :overlap] * ramp
                    video = torch.cat([video[:, :, :-overlap], blended, cur[:, :, overlap:]], dim=2)
        video = video[:, :, :total_pixel_frames]
    return _to_uint8_frames(video).cpu().numpy()


def temporal_chunks(t_latent: int, temporal_chunk_size: int = 0, temporal_overlap: int = 2):
    """The (start, end) latent-frame ranges decode_latent decodes: one pass
    when temporal_chunk_size is 0 or covers the clip, else overlapping
    chunks at a stride of temporal_chunk_size - temporal_overlap."""
    if temporal_chunk_size <= 0 or t_latent <= temporal_chunk_size:
        return [(0, t_latent)]
    chunks, t = [], 0
    while True:
        end = min(t + temporal_chunk_size, t_latent)
        chunks.append((t, end))
        if end >= t_latent:
            return chunks
        t += temporal_chunk_size - temporal_overlap
