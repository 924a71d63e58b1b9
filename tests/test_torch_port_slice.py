"""The port's whole slice against the JAX package, and its boundaries.

- noise -> 3-step distilled loop -> un-patchify -> chunked VAE decode ->
  uint8 frames through `generate_videos`, held against the same chain of
  JAX functions (scripts/bench_e2e.py's steps) on the same weights, noise
  and context, in float32 on the CPU: frames within 1 level.
- No module of ltx2_tpu_torch, nor chip_smoke.py, imports jax, ltx2_tpu,
  ml_dtypes or PIL (a static scan: every process here has JAX loaded
  already, so sys.modules proves nothing; the card's machine has neither
  ml_dtypes nor PIL).
- Entry points default to CUDA and raise without it; chip_smoke.py fails
  without a card and outside a checkout, printing no result.
"""

import ast
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components import DISTILLED_SIGMA_VALUES, CFGGuider
from ltx2_tpu.components.noisers import _blend as jblend
from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.video_vae import chunking as jchunking
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.pipelines import denoise as jdenoise
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu.types import VideoPixelShape as JPixel
from ltx2_tpu_torch.generate import generate_video, generate_videos
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, video_decoder_from_numpy
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig
from tests.torch_port_util import CFG, JCFG, numpy_tree, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

ROOT = Path(__file__).resolve().parent.parent
FRAMES, HEIGHT, WIDTH, STEPS = 65, 64, 64, 3  # 9 latent frames: the decode runs in 2 chunks of <= 7


def test_slice_matches_jax_within_one_level():
    jdcfg = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                                        decode_noise_scale=0.0)
    dcfg = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                              decode_noise_scale=0.0)  # decode noise comes from each package's RNG
    dit_tree = numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG), seed=1)
    dec_tree = numpy_tree(jax.jit(lambda k: jdecoder.init_video_decoder(k, jdcfg))(jax.random.PRNGKey(1)), seed=2)

    shape = JShape.from_pixel_shape(JPixel(1, FRAMES, HEIGHT, WIDTH, 24.0), latent_channels=16)
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((1, shape.tokens, 16)).astype(np.float32)
    context = (rng.standard_normal((1, 16, 256)) * 0.02).astype(np.float32)

    jtools = JTools(JPatchifier(1), shape, fps=24.0)
    state = jblend(jtools.create_initial_state(), jnp.asarray(noise), 1.0)
    loop = jdenoise.make_video_denoise_loop(
        JCFG, jdenoise.DenoiseLoopConfig(guider=CFGGuider(1.0), uniform_timesteps=True)
    )
    jp = jax.tree_util.tree_map(jnp.asarray, dit_tree)
    sigmas = jnp.asarray(DISTILLED_SIGMA_VALUES[: STEPS + 1], jnp.float32)
    out = loop(jp, state, sigmas, jnp.asarray(context), jnp.asarray(context))
    ref = jchunking.decode_latent(
        jtools.unpatchify(out).latent, jax.tree_util.tree_map(jnp.asarray, dec_tree), jdcfg,
        timestep=0.05, temporal_chunk_size=7,
    )

    videos, stats = generate_videos(
        [0], height=HEIGHT, width=WIDTH, frames=FRAMES, steps=STEPS, device="cpu",
        dit=dit_from_numpy(dit_tree, CFG), decoder=video_decoder_from_numpy(dec_tree, dcfg),
        contexts=[t(context)], noises=[t(noise)],
    )
    assert videos[0].shape == ref.shape == (FRAMES, HEIGHT, WIDTH, 3) and videos[0].dtype == np.uint8
    assert np.abs(videos[0].astype(int) - ref.astype(int)).max() <= 1
    assert stats[0]["latent_finite"] and stats[0]["attention_launches"] == 0  # CPU: plain path


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "ltx2_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    # The full VAE, the WebP reader, pipeline parallelism, the layout
    # advisor and its FLOP count, and the still readers are in the scan.
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"ltx2_tpu_torch/models/video_vae/resnet.py", "ltx2_tpu_torch/models/video_vae/full_vae.py",
            "ltx2_tpu_torch/utils/webp.py", "ltx2_tpu_torch/utils/vp8.py", "ltx2_tpu_torch/utils/vp8l.py",
            "ltx2_tpu_torch/parallel/pipeline_parallel.py", "ltx2_tpu_torch/parallel/advisor.py",
            "ltx2_tpu_torch/utils/flops.py", "ltx2_tpu_torch/utils/still_io.py", "ltx2_tpu_torch/utils/image_io.py",
            "ltx2_tpu_torch/utils/jpeg.py", "ltx2_tpu_torch/utils/gif.py"} <= names
    bad = [
        (str(f.relative_to(ROOT)), mod) for f in files for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "ltx2_tpu", "ml_dtypes", "PIL", "transformers", "tokenizers",
                                 "sentencepiece")
    ]
    assert not bad, f"the port imports JAX, the JAX package, ml_dtypes, PIL or a tokenizer library: {bad}"


def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_video()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_videos([0], device="cuda")


def test_dit_and_decoder_defaults_are_the_full_width_model():
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig

    full = LTXModelConfig()
    assert (full.num_layers, full.video_inner_dim, full.cross_attention_dim) == (48, 4096, 4096)
    assert dataclasses.asdict(VideoDecoderConfig())["base_channels"] == 128


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_checkout(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]
    for ln in lines:
        with pytest.raises(json.JSONDecodeError):
            json.loads(ln)
