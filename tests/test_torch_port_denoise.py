"""Parity of the port's denoise loop and diffusion components with the JAX
package, in float32 on the CPU: 3 Euler steps over a 2-layer DiT with the
initial noise injected into both (the two RNGs differ), to a relative 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components import CFGGuider as JCFGGuider
from ltx2_tpu.components.noisers import _blend as jblend
from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.pipelines import denoise as jdenoise
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu.types import VideoPixelShape as JPixel
from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from ltx2_tpu_torch.types import VideoLatentShape, VideoPixelShape
from tests.torch_port_util import CFG, JCFG, assert_close, numpy_tree, t

SIGMAS = np.array([1.0, 0.909375, 0.421875, 0.0], np.float32)  # 3 steps, down to 0
SHAPE = (1, 16, 2, 2, 3)


@pytest.fixture(scope="module")
def weights():
    tree = numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(3), JCFG), seed=4)
    return jax.tree_util.tree_map(jnp.asarray, tree), dit_from_numpy(tree, CFG)


def test_latent_shapes_and_tools():
    pixel = (1, 121, 512, 768, 24.0)
    assert tuple(VideoLatentShape.from_pixel_shape(VideoPixelShape(*pixel))) == tuple(
        JShape.from_pixel_shape(JPixel(*pixel))
    )
    jtools = JTools(JPatchifier(1), JShape(*SHAPE), fps=24.0)
    tools = VideoLatentTools(VideoLatentPatchifier(1), VideoLatentShape(*SHAPE), fps=24.0)
    grid = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    jstate = jtools.create_initial_state(initial_latent=jnp.asarray(grid))
    state = tools.create_initial_state(initial_latent=t(grid))
    for name in ("latent", "denoise_mask", "positions", "clean_latent"):
        assert_close(getattr(state, name), getattr(jstate, name), rtol=0, msg=name)
    assert_close(tools.unpatchify(state).latent, grid, rtol=0, msg="unpatchify")
    cleared = tools.clear_conditioning(state)
    assert cleared.latent.shape == (1, 12, 16)
    with pytest.raises(ValueError):
        tools.create_initial_state(initial_latent=torch.zeros(1, 16, 2, 2, 2))


def test_noiser_blends_by_mask():
    tools = VideoLatentTools(VideoLatentPatchifier(1), VideoLatentShape(*SHAPE), fps=24.0)
    state = tools.create_initial_state()
    noise = np.random.default_rng(1).standard_normal((1, 12, 16)).astype(np.float32)
    out = GaussianNoiser()(None, state, 0.75, noise=t(noise))
    jtools = JTools(JPatchifier(1), JShape(*SHAPE), fps=24.0)
    ref = jblend(jtools.create_initial_state(), jnp.asarray(noise), 0.75)
    assert_close(out.latent, ref.latent, msg="blend")
    drawn = GaussianNoiser()(torch.Generator().manual_seed(0), state).latent
    assert drawn.shape == (1, 12, 16) and float(drawn.std()) > 0.5


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_denoise_loop(weights, cfg_scale):
    jp, port = weights
    rng = np.random.default_rng(5)
    noise = rng.standard_normal((1, 12, 16)).astype(np.float32)
    pos_ctx = (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32)
    neg_ctx = (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32)

    jtools = JTools(JPatchifier(1), JShape(*SHAPE), fps=24.0)
    jstate = jblend(jtools.create_initial_state(), jnp.asarray(noise), 1.0)
    jloop = jdenoise.make_video_denoise_loop(
        JCFG, jdenoise.DenoiseLoopConfig(guider=JCFGGuider(cfg_scale), uniform_timesteps=True)
    )
    ref = jloop(jp, jstate, jnp.asarray(SIGMAS), jnp.asarray(pos_ctx), jnp.asarray(neg_ctx))

    tools = VideoLatentTools(VideoLatentPatchifier(1), VideoLatentShape(*SHAPE), fps=24.0)
    state = GaussianNoiser()(None, tools.create_initial_state(), 1.0, noise=t(noise))
    loop = make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=CFGGuider(cfg_scale), uniform_timesteps=True))
    out = loop(port, state, t(SIGMAS), t(pos_ctx), t(neg_ctx))
    assert_close(out.latent, ref.latent, msg=f"loop cfg={cfg_scale}")


@pytest.mark.parametrize("field,value", [
    ("sampler", "heun"), ("stg_scale", 1.0), ("cfg_interval", 2), ("ge_gamma", 0.5),
    ("cross_attn_scale", 0.5), ("cache_text_kv", True),
])
def test_loop_refuses_unported_options(field, value):
    with pytest.raises(NotImplementedError, match="not ported"):
        make_video_denoise_loop(CFG, DenoiseLoopConfig(**{field: value}))


def test_loop_refuses_parallelism_and_other_guiders():
    with pytest.raises(NotImplementedError):
        make_video_denoise_loop(CFG, DenoiseLoopConfig(), mesh=object())

    class APG(CFGGuider):
        momentum = 0.5

    with pytest.raises(NotImplementedError):
        make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=APG(2.0)))
