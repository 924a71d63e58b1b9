"""Checkpoint -> DiT, video-only or audio-video, V1 or V2 (LTX-2.3), with
key rewriting and fp8 (counterpart of ltx2_tpu/loader/weight_loader.py).

The reference checkpoint keeps every component in one safetensors file; the
DiT's tensors are `model.diffusion_model.*`. Their names become the port's
parameter names by the rewrite rules below (data, as in the JAX package);
the JAX package stacks the blocks on a layer axis, the port keeps them per
block, which are the checkpoint's own names. Each tensor is read from the
mapped file, moved to the module's device and converted there, one tensor at
a time (loader/modules.py): AdaLN tables and norm weights in fp32, matmul
weights in the target dtype, fp8-E4M3 weights dequantized (codes x
per-tensor scale) or, with `keep_fp8`, kept as codes with their scales
(the audio stream's and the cross-modal linears as the video's, as the JAX
loader keeps every weight that has a scale), or, with `quantize_int8`,
quantized to int8 W8A8 on the host one tensor at a time
(loader/int8.py), so the card never holds the unquantized tree.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

import torch

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.convert import fp8_e4m3_dequant, to_dtype
from ltx2_tpu_torch.loader.fp8 import set_fp8_weight_
from ltx2_tpu_torch.loader.int8 import int8_eligible, quantize_array_int8, set_int8_weight_
from ltx2_tpu_torch.loader.modules import assign_, require_loaded
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile, read_metadata
from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelConfig, LTXModelType
from ltx2_tpu_torch.ops.common import Linear

# The reference's key rewrites, checkpoint name -> module name.
KEY_REWRITE_RULES: List[Tuple[str, str]] = [
    (r"\.to_out\.0\.", ".to_out."),
    (r"\.audio_ff\.net\.0\.proj\.", ".audio_ff.project_in.proj."),
    (r"\.audio_ff\.net\.2\.", ".audio_ff.project_out."),
    (r"\.ff\.net\.0\.proj\.", ".ff.project_in.proj."),
    (r"\.ff\.net\.2\.", ".ff.project_out."),
]

DIFFUSION_PREFIX = "model.diffusion_model."
# Tensors whose module name holds one of these load in fp32 whatever the
# target dtype (docs/PARITY.md: fp32 AdaLN and norms).
FP32_KEYS = ("scale_shift_table", "adaln", "norm")


def convert_checkpoint_key(key: str, include_audio: bool = False) -> Optional[str]:
    """A DiT checkpoint key (diffusion prefix stripped) -> module name; None
    for keys the DiT skips (audio on a video-only load, the text
    connectors, which belong to the text encoder)."""
    if not include_audio and ("av_ca" in key or "a2v" in key or "audio" in key.lower()):
        return None
    if "video_embeddings_connector" in key or "audio_embeddings_connector" in key:
        return None
    for pattern, repl in KEY_REWRITE_RULES:
        key = re.sub(pattern, repl, key)
    return key


def is_fp8_checkpoint(path: str) -> bool:
    """fp8 checkpoints ship per-tensor `.weight_scale` entries."""
    return any(k.endswith(".weight_scale") for k in SafetensorsFile(path).keys())


def detect_model_version(path: str) -> str:
    """`model_version` from the metadata ("" when absent or unreadable)."""
    try:
        return read_metadata(path).get("model_version", "")
    except (OSError, ValueError):
        return ""


def is_v2_model(path: str) -> bool:
    return detect_model_version(path).startswith("2.3")


def read_checkpoint_config(path: str) -> dict:
    """The metadata's JSON `config` blob ({} when absent or unreadable)."""
    try:
        return json.loads(read_metadata(path).get("config", "{}"))
    except (OSError, ValueError):
        return {}


def fp8_scale_keys(f: SafetensorsFile) -> Dict[str, str]:
    """{weight key: its scale key} for the file's fp8 weights."""
    return {k[: -len("_scale")]: k for k in f.keys() if k.endswith(".weight_scale")}


def per_tensor_scale(f: SafetensorsFile, key: str, scale_key: str) -> torch.Tensor:
    """The fp8 weight's scale as a 0-d fp32 tensor; refuses a scale of more
    than one element (the reference layout is per tensor, and dequantizing
    by element 0 would corrupt every other channel)."""
    scale = f.get(scale_key)
    if scale.numel() != 1:
        raise ValueError(f"{key}: weight_scale has {scale.numel()} elements; only per-tensor fp8 scales are "
                         "supported (reference layout)")
    return scale.reshape(()).to(torch.float32)


def convert_tensor(t: torch.Tensor, tree_key: str, target_dtype: torch.dtype) -> torch.Tensor:
    """One tensor's dtype policy: fp32 for AdaLN tables and norms, the
    target dtype for the rest (a non-bf16 source narrows to bf16 through
    fp32, as the JAX package's conversion does)."""
    if any(marker in tree_key for marker in FP32_KEYS):
        return t.to(torch.float32)
    if target_dtype == torch.bfloat16 and t.dtype != torch.bfloat16:
        return to_dtype(t.to(torch.float32), torch.bfloat16)
    return t.to(target_dtype)


def read_dequantized(f: SafetensorsFile, key: str, scales: Dict[str, str], device: torch.device) -> torch.Tensor:
    """The tensor `key` on `device`, dequantized to fp32 when it is an fp8
    weight with a scale; a fresh tensor, never a view of the file."""
    t = f.get(key).to(device, copy=True)
    if key in scales:
        t = fp8_e4m3_dequant(t, float(per_tensor_scale(f, key, scales[key])), torch.float32)
    return t


_BLOCK_RE = re.compile(r"transformer_blocks\.(\d+)\.")


def transformer_config_from_checkpoint(path: str, compute_dtype: str = "bfloat16",
                                       include_audio: bool = False) -> LTXModelConfig:
    """The DiT's architecture from the file: widths from the tensors'
    shapes, the block count from their names, the head counts from the
    metadata's config (`num_attention_heads`, `audio_num_attention_heads`,
    top level or under "transformer"; 32 when absent). A `model_version` of
    2.3 (LTX-2.3, V2) turns on cross-attention AdaLN and gated attention, as
    the JAX ledger builds V2. With `include_audio` the audio-video model
    (the file must hold the audio stream). The rest: SPLIT RoPE on the f32
    grid, caption projections when the file has them (V1; V2 has none); no
    remat (serving)."""
    f = SafetensorsFile(path)
    meta = read_checkpoint_config(path)
    tcfg = meta.get("transformer", {}) or meta

    def shape(name: str) -> Tuple[int, ...]:
        return f.info(DIFFUSION_PREFIX + name)[1]

    inner, in_channels = shape("patchify_proj.weight")
    heads = int(tcfg.get("num_attention_heads", 32))
    head_dim = int(tcfg.get("attention_head_dim", inner // heads))
    if heads * head_dim != inner:
        raise ValueError(f"{path}: {heads} heads x {head_dim} do not make the DiT's width {inner}")
    names = [k[len(DIFFUSION_PREFIX):] for k in f.keys() if k.startswith(DIFFUSION_PREFIX)]
    blocks = {int(m.group(1)) for m in map(_BLOCK_RE.match, names) if m}
    caption = shape("caption_projection.linear_1.weight")[1] if "caption_projection.linear_1.weight" in names else None
    v2 = is_v2_model(path)
    audio = {}
    if include_audio:
        if "audio_patchify_proj.weight" not in names:
            raise ValueError(f"{path} holds no audio stream (audio_patchify_proj): load it without include_audio")
        audio_inner, audio_in = shape("audio_patchify_proj.weight")
        audio_heads = int(tcfg.get("audio_num_attention_heads", 32))
        audio = dict(model_type=LTXModelType.AudioVideo, audio_heads=audio_heads,
                     audio_head_dim=int(tcfg.get("audio_attention_head_dim", audio_inner // audio_heads)),
                     audio_in_channels=audio_in, audio_out_channels=shape("audio_proj_out.weight")[0])
        if audio["audio_heads"] * audio["audio_head_dim"] != audio_inner:
            raise ValueError(f"{path}: {audio_heads} audio heads do not make the audio stream's width {audio_inner}")
    return LTXModelConfig(
        num_attention_heads=heads, attention_head_dim=head_dim, in_channels=in_channels,
        out_channels=shape("proj_out.weight")[0], num_layers=max(blocks) + 1 if blocks else 0,
        cross_attention_dim=shape("transformer_blocks.0.attn2.to_k.weight")[1], caption_channels=caption,
        compute_dtype=compute_dtype, remat=False, cross_attention_adaln=v2, apply_gated_attention=v2, **audio,
    )


@torch.no_grad()
def load_transformer_params(
    path: str,
    cfg: Optional[LTXModelConfig] = None,
    *,
    target_dtype: str = "bfloat16",
    device=None,
    keep_fp8: bool = False,
    quantize_int8: bool = False,
    include_audio: bool = False,
) -> LTXModel:
    """The DiT of the checkpoint at `path` on `device` (default cuda), read
    tensor by tensor (host memory: one tensor): the video stream, and with
    `include_audio` the audio stream and the cross-modal layers too (the
    audio-video model). `cfg` defaults to `transformer_config_from_checkpoint`. With `keep_fp8` the file's fp8
    weights stay E4M3 codes with their per-tensor `weight_scale`, dequantized
    at use; otherwise they are dequantized here. With `quantize_int8` every
    `int8_eligible` weight, converted as `convert_tensor` gives it, is
    quantized on the host (`quantize_array_int8`) and moved as int8 codes
    with its `weight_cscale`; it excludes `keep_fp8`, as in the JAX package.
    Every other tensor follows `convert_tensor`. Raises on a tensor the
    model has no place for, one of another shape, and a model tensor the
    file does not give."""
    if keep_fp8 and quantize_int8:
        raise ValueError("keep_fp8 and quantize_int8 are mutually exclusive")
    device = resolve_device(device)
    if cfg is None:
        cfg = transformer_config_from_checkpoint(path, target_dtype, include_audio)
    if cfg.is_av != include_audio:
        raise ValueError(f"include_audio={include_audio} with a {cfg.model_type.name} config")
    target = getattr(torch, target_dtype)
    f = SafetensorsFile(path)
    scales = fp8_scale_keys(f)
    model = LTXModel(cfg, device="meta")
    try:
        for key in sorted(f.keys()):
            if not key.startswith(DIFFUSION_PREFIX) or key.endswith("_scale"):
                continue
            tree_key = convert_checkpoint_key(key[len(DIFFUSION_PREFIX):], include_audio)
            if tree_key is None:
                continue
            if keep_fp8 and key in scales:
                owner = model.get_submodule(tree_key.rpartition(".")[0])
                if not isinstance(owner, Linear) or not tree_key.endswith(".weight"):
                    raise ValueError(f"{key}: an fp8 weight outside a linear layer cannot stay quantized")
                set_fp8_weight_(owner, f.get(key).to(device, copy=True),
                                per_tensor_scale(f, key, scales[key]).to(device))
                continue
            if quantize_int8 and int8_eligible(tree_key):
                owner = model.get_submodule(tree_key.rpartition(".")[0])
                host = convert_tensor(read_dequantized(f, key, scales, torch.device("cpu")), tree_key, target)
                codes, cscale = quantize_array_int8(host.float().numpy())
                set_int8_weight_(owner, torch.from_numpy(codes).to(device), torch.from_numpy(cscale).to(device))
                continue
            assign_(model, tree_key, convert_tensor(read_dequantized(f, key, scales, device), tree_key, target))
    finally:
        f.close()
    require_loaded(model, path, "DiT")
    return model
