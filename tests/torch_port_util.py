"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU, the port with device="cpu", both in float32.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu_torch.loader.from_numpy import flatten_tree
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.ops import attention

# Relative tolerance of the float32 parity tests: the two packages sum in
# different orders, nothing else differs.
RTOL = 1e-4

# The small DiT of the parity tests: 2 layers, 2 heads x 128, 16 latent
# channels, 256-d text context.
JCFG = jmodel.LTXModelConfig(
    model_type=jmodel.LTXModelType.VideoOnly, num_attention_heads=2, attention_head_dim=128,
    in_channels=16, out_channels=16, num_layers=2, cross_attention_dim=256,
    caption_channels=None, compute_dtype="float32", remat=False,
)
CFG = model.LTXModelConfig(
    num_attention_heads=2, attention_head_dim=128, in_channels=16, out_channels=16,
    num_layers=2, cross_attention_dim=256, compute_dtype="float32",
)


@pytest.fixture(scope="module")
def one_intra_op_thread():
    """torch on one intra-op thread for a module's tests, restored after.
    The tests run in several worker processes side by side; each torch's
    default thread pool (one thread a core) then oversubscribes the cores,
    and its small ops spend their time waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, rtol: float = RTOL, msg: str = "") -> None:
    """|port - ref| <= rtol * max|ref| elementwise (a relative bound on the
    tensor's scale, so entries near zero do not dominate)."""
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, f"{msg}: shape {a.shape} vs {b.shape}"
    a, b = a.astype(np.float64), b.astype(np.float64)
    scale = max(np.abs(b).max(), 1e-12)
    err = np.abs(a - b).max()
    assert err <= rtol * scale, f"{msg}: max abs err {err:.3e} > {rtol} * {scale:.3e}"


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32) if np.asarray(x).dtype.kind == "f" else np.array(x))


def numpy_tree(tree, seed: int, randomize=("scale_shift_table", "norm", "statistics")):
    """JAX param tree -> numpy tree; leaves whose path names one of
    `randomize` (zero/one-initialised tables, norms, VAE statistics) get
    random values so those code paths are exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, dtype=np.float32)
        name = jax.tree_util.keystr(path)
        if any(r in name for r in randomize):
            if "std_of_means" in name:
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return (rng.standard_normal(x.shape) * 0.3 + (1.0 if "norm" in name else 0.0)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def force_flash_route(monkeypatch) -> dict:
    """Sends every `sdpa` call without a query-dependent mask to the flash
    kernels' route whatever its dtype, the route the card takes for the
    DiT's bf16 attention, so that an fp32 model on the CPU runs the kernels'
    plain versions (forward, and FlashAttention's backward under a gradient)
    in place of `sdpa_plain`. Returns the counts of the calls it sees, by
    "forward" and "backward"."""
    seen = {"forward": 0, "backward": 0}
    fwd, bwd = attention.flash_attention, attention.flash_attention_bwd

    def forward(*args, **kwargs):
        seen["forward"] += 1
        return fwd(*args, **kwargs)

    def backward(*args, **kwargs):
        seen["backward"] += 1
        return bwd(*args, **kwargs)

    monkeypatch.setattr(attention, "attention_route", lambda dtype, t_q, t_k, d, kind:
                        "plain" if kind == "query" else "kernel")
    monkeypatch.setattr(attention, "flash_attention", forward)
    monkeypatch.setattr(attention, "flash_attention_bwd", backward)
    return seen


def bits(x):
    """(dtype name, shape, raw bytes) of a torch tensor or numpy/JAX array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return str(x.dtype).rsplit(".", 1)[-1], tuple(x.shape), x.reshape(-1).view(torch.uint8).numpy()
    a = np.asarray(x)  # (np.ascontiguousarray would make a 0-d array 1-d)
    return a.dtype.name, a.shape, np.ascontiguousarray(a.reshape(-1)).view(np.uint8)


def assert_bitwise(port, ref, msg=""):
    (pd, ps, pb), (rd, rs, rb) = bits(port), bits(ref)
    assert (pd, ps) == (rd, rs), f"{msg}: {pd}{ps} vs {rd}{rs}"
    assert np.array_equal(pb, rb), f"{msg}: bits differ"


def jax_leaves(tree, stacked="transformer_blocks"):
    """A JAX tree -> {port name: numpy leaf}, stacked leaves split per block."""
    out = {}
    for key, a in flatten_tree(tree).items():
        head, _, rest = key.partition(".")
        if head == stacked:
            out.update({f"{stacked}.{i}.{rest}": a[i] for i in range(a.shape[0])})
        else:
            out[key] = a
    return out


def port_leaves(module):
    return dict((*module.named_parameters(), *module.named_buffers()))


def assert_module_matches_tree(module, tree, stacked="transformer_blocks"):
    ref, got = jax_leaves(tree, stacked), port_leaves(module)
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))[:6]
    for name, leaf in got.items():
        assert_bitwise(leaf, ref[name], name)


def write_png(path, pixels, color_type=None, filters=(0, 1, 2, 3, 4)):
    """An 8-bit PNG of uint8 pixels (H, W) grayscale, (H, W, 3) RGB or
    (H, W, 4) RGBA, written with zlib; row y uses filter filters[y %
    len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), so a reader
    meets every filter."""
    import struct
    import zlib

    px = np.asarray(pixels, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, bpp = px.shape
    color_type = {1: 0, 3: 2, 4: 6}[bpp] if color_type is None else color_type
    cur = px.reshape(h, w * bpp).astype(np.int64)
    up = np.vstack([np.zeros((1, w * bpp), np.int64), cur[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), cur[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int64), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(cur), left, up, (left + up) >> 1, paeth]
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        rows.append(bytes([f]) + ((cur[y] - preds[f][y]) & 255).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    return path


def random_tree(module, seed: int):
    """Random float32 numpy weights for every tensor of a port module, as
    the JAX package's nested tree (lists where the names index), without
    the JAX package's jitted inits: weights U(+-1/sqrt(fan_in)), biases
    U(+-0.05), norms and tables as `numpy_tree` randomizes them, the VAE
    statistics around 0 and 1, 0-d buffers (the decoder's timestep
    multiplier) kept."""
    rng = np.random.default_rng(seed)
    root = {}
    for name, p in (*module.named_parameters(), *module.named_buffers()):
        shape = tuple(p.shape)
        if not shape:
            x = p.detach().float().numpy()
        elif "std_of_means" in name:
            x = rng.uniform(0.5, 1.5, shape)
        elif any(r in name for r in ("scale_shift_table", "norm", "statistics")):
            x = rng.standard_normal(shape) * 0.3 + (1.0 if "norm" in name else 0.0)
        elif len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            x = rng.uniform(-bound, bound, shape)
        else:
            x = rng.uniform(-0.05, 0.05, shape)
        node, parts = root, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(x, np.float32)

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


# The loop parity tests: the 2-layer DiT above on a 1 x 16 x 2 x 2 x 3 latent
# (12 tokens), 3 steps down to 0.
LOOP_SHAPE = (1, 16, 2, 2, 3)
LOOP_SIGMAS = np.array([1.0, 0.909375, 0.421875, 0.0], np.float32)


def stacked_dit_tree(port_cfg=CFG, seed: int = 4):
    """Random float32 DiT weights (`random_tree` over the port's module) in
    the JAX package's layout: each block leaf stacked on a leading layer axis."""
    tree = random_tree(model.LTXModel(port_cfg, device="meta"), seed)
    tree["transformer_blocks"] = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *tree["transformer_blocks"])
    return tree


def make_guiders(spec):
    """(class name, kwargs) -> the guider of that name in each package (JAX, port)."""
    from ltx2_tpu.components import guiders as jguiders
    from ltx2_tpu_torch.components import guiders

    name, kwargs = spec
    return getattr(jguiders, name)(**kwargs), getattr(guiders, name)(**kwargs)


def run_loops(jparams, port_model, guider, opts=None, *, seed: int = 5, bucket: int = 0, per_token: bool = False,
              jcfg=JCFG, port_cfg=CFG, sigmas=LOOP_SIGMAS, port_only: bool = False):
    """The JAX package's video denoise loop and the port's on the same
    weights, noise and contexts (drawn with numpy from `seed`): returns
    (port latent, JAX latent) as numpy, the JAX one None with `port_only`.
    guider: (class name, kwargs); opts: the other DenoiseLoopConfig fields;
    per_token: latent frame 0 conditioned at strength 0.95 (per-token
    timesteps); bucket: the state padded to a multiple of it with a token
    mask and sliced back after the loop."""
    from ltx2_tpu.components.noisers import _blend as jblend
    from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
    from ltx2_tpu.conditioning import latent as jlatent
    from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
    from ltx2_tpu.pipelines import common as jcommon
    from ltx2_tpu.pipelines import denoise as jdenoise
    from ltx2_tpu.types import VideoLatentShape as JShape
    from ltx2_tpu_torch.components.noisers import GaussianNoiser
    from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
    from ltx2_tpu_torch.conditioning.latent import VideoConditionByLatentIndex
    from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
    from ltx2_tpu_torch.pipelines import common
    from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
    from ltx2_tpu_torch.types import VideoLatentShape

    import jax.numpy as jnp

    opts = dict(opts or {})
    b, c, f, h, w = LOOP_SHAPE
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((b, f * h * w, c)).astype(np.float32)
    pos = (rng.standard_normal((b, 16, jcfg.cross_attention_dim)) * 0.5).astype(np.float32)
    neg = (rng.standard_normal((b, 16, jcfg.cross_attention_dim)) * 0.5).astype(np.float32)
    clean = rng.standard_normal((b, c, 1, h, w)).astype(np.float32)
    jguider, guider = make_guiders(guider)

    tools = VideoLatentTools(VideoLatentPatchifier(1), VideoLatentShape(*LOOP_SHAPE), fps=24.0)
    state = tools.create_initial_state(dtype=port_cfg.dtype)
    if per_token:
        state = VideoConditionByLatentIndex(t(clean).to(port_cfg.dtype), 0.95, 0).apply_to(state, tools)
    state = GaussianNoiser()(None, state, 1.0, noise=t(noise))
    loop = make_video_denoise_loop(port_cfg, DenoiseLoopConfig(guider=guider, uniform_timesteps=not per_token,
                                                               **opts))
    n, token_mask = state.latent.shape[1], None
    if bucket:
        state, token_mask = common.pad_state_tokens(state, common.bucketed_tokens(n, bucket))
    dtype = port_cfg.dtype
    out = loop(port_model, state, t(sigmas), t(pos).to(dtype), t(neg).to(dtype), token_mask=token_mask)
    port_latent = common.slice_state_tokens(out, n).latent.float().numpy()
    if port_only:
        return port_latent, None

    jdtype = jnp.dtype(jcfg.compute_dtype)
    jtools = JTools(JPatchifier(1), JShape(*LOOP_SHAPE), fps=24.0)
    jstate = jtools.create_initial_state(dtype=jdtype)
    if per_token:
        jstate = jlatent.VideoConditionByLatentIndex(jnp.asarray(clean, jdtype), 0.95, 0).apply_to(jstate, jtools)
    jstate = jblend(jstate, jnp.asarray(noise), 1.0)
    jloop = jdenoise.make_video_denoise_loop(jcfg, jdenoise.DenoiseLoopConfig(
        guider=jguider, uniform_timesteps=not per_token, **opts))
    jmask = None
    if bucket:
        jstate, jmask = jcommon.pad_state_tokens(jstate, jcommon.bucketed_tokens(n, bucket))
    jout = jloop(jparams, jstate, jnp.asarray(sigmas), jnp.asarray(pos, jdtype), jnp.asarray(neg, jdtype),
                 token_mask=jmask)
    return port_latent, np.asarray(jcommon.slice_state_tokens(jout, n).latent.astype(jnp.float32))


TOKENIZER_CORPUS = ["A cinematic shot of the ocean at sunset",
                    "worst quality, inconsistent motion, blurry, jittery, distorted",
                    "a red fox runs through snow at dawn", "waves crash on black rocks"] * 8


def write_tokenizer(directory, vocab_size: int = 120):
    """A small BPE tokenizer of at most `vocab_size` tokens (the tiny
    Gemma's vocabulary holds 128), trained with `tokenizers` on a few
    prompts: spaces replaced by ▁, <unk> for unseen characters, a <bos>
    template, <pad> for padding and one added token, <extra>. Writes
    tokenizer.json and tokenizer_config.json into `directory` (made if
    needed) and returns it as a string."""
    import json
    import os

    from tokenizers import Tokenizer, models, normalizers, processors, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.normalizer = normalizers.Replace(" ", "▁")
    tok.train_from_iterator(TOKENIZER_CORPUS, trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<pad>", "<eos>", "<bos>", "<unk>", "<extra>"], show_progress=False))
    tok.post_processor = processors.TemplateProcessing(single="<bos> $A", special_tokens=[("<bos>", 2)])
    spec = json.loads(tok.to_str())
    for added in spec["added_tokens"]:
        if added["content"] == "<extra>":
            added["special"] = False
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "tokenizer.json"), "w", encoding="utf-8") as fh:
        json.dump(spec, fh)
    with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as fh:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<bos>", "eos_token": "<eos>",
                   "pad_token": "<pad>", "unk_token": "<unk>", "model_max_length": 1_000_000}, fh)
    return str(directory)
