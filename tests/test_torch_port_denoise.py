"""Parity of the port's denoise loop and diffusion components with the JAX
package, in float32 on the CPU: 3 Euler steps over a 2-layer DiT with the
initial noise injected into both (the two RNGs differ), to a relative 1e-4;
the guiders (rescaled CFG, STG, APG with and without its clamp, the stateful
APG and its carry) on the same rows to 1e-6, the Heun step bit for bit, and
the loop's STG flags, cross-attention scales and pass-major perturbation
layout. The loop's options: test_torch_port_loop_options.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components import CFGGuider as JCFGGuider
from ltx2_tpu.components import diffusion_steps as jdiffusion_steps
from ltx2_tpu.components.perturbations import PerturbationType as JPerturbationType
from ltx2_tpu.components.noisers import _blend as jblend
from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.pipelines import denoise as jdenoise
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu.types import VideoPixelShape as JPixel
from ltx2_tpu_torch.components import diffusion_steps, guiders
from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.components.perturbations import PerturbationType
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.pipelines import denoise
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from ltx2_tpu_torch.types import VideoLatentShape, VideoPixelShape
from tests.torch_port_util import CFG, JCFG, assert_bitwise, assert_close, make_guiders, numpy_tree, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

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


def test_loop_refuses_parallelism_and_other_guiders():
    """Guidance reuse does not compose with pipeline parallelism (its
    microbatches are the guidance rows); the stateful APG does not compose
    with guidance reuse (its EMA needs a fresh uncond every step), as in JAX."""
    with pytest.raises(NotImplementedError):
        make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=CFGGuider(3.0), cfg_interval=2), pipeline_axis="pipe")
    with pytest.raises(ValueError, match="APG momentum"):
        make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=guiders.StatefulAPGGuider(2.0, 0.5, momentum=0.5),
                                                       cfg_interval=2))
    with pytest.raises(ValueError, match="APG momentum"):  # the attribute decides, not its value
        make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=guiders.StatefulAPGGuider(2.0, 0.5), cfg_interval=2))


# guider -> (class name, kwargs); each computed on the same (2, 12, 16)
# rows in both packages, per batch row.
GUIDERS = {
    "rescaled_cfg": ("RescaledCFGGuider", {"scale": 3.0, "rescale": 0.7}),
    "stg": ("STGGuider", {"scale": 1.5}),
    "apg": ("LtxAPGGuider", {"scale": 3.0, "eta": 0.5}),
    "apg_clamp": ("LtxAPGGuider", {"scale": 3.0, "eta": 0.5, "norm_threshold": 2.0}),
    "stateful_apg": ("StatefulAPGGuider", {"scale": 3.0, "eta": 0.5, "norm_threshold": 2.0, "momentum": 0.5}),
    "stateful_apg_no_momentum": ("StatefulAPGGuider", {"scale": 3.0, "eta": 0.5}),
}


@pytest.mark.parametrize("name", sorted(GUIDERS))
def test_guiders_match_jax(name):
    rng = np.random.default_rng(2)
    cond, uncond = (rng.standard_normal((2, 12, 16)).astype(np.float32) for _ in range(2))
    uncond[1] *= 3.0  # the second row's guidance is larger: the clamp differs per row
    jguider, guider = make_guiders(GUIDERS[name])
    if name.startswith("stateful"):
        carry = rng.standard_normal((2, 12, 16)).astype(np.float32)
        for c in (None, carry):
            out, new = guider.guide(t(cond), t(uncond), None if c is None else t(c))
            ref, jnew = jguider.guide(jnp.asarray(cond), jnp.asarray(uncond), None if c is None else jnp.asarray(c))
            assert_close(out, ref, rtol=1e-6, msg=name)
            assert_close(new, jnew, rtol=1e-6, msg=f"{name} carry")
        assert guider.enabled() and not guiders.StatefulAPGGuider(0.0, 1.0).enabled()
        assert guiders.LegacyStatefulAPGGuider is guiders.StatefulAPGGuider
    else:
        assert_close(guider.guide(t(cond), t(uncond)), jguider.guide(jnp.asarray(cond), jnp.asarray(uncond)),
                     rtol=1e-6, msg=name)
        assert_close(guider.delta(t(cond), t(uncond)), jguider.delta(jnp.asarray(cond), jnp.asarray(uncond)),
                     rtol=1e-6, msg=f"{name} delta")
        assert guider.enabled() == jguider.enabled()
    cfg16 = guiders.rescale_noise_cfg(t(cond).bfloat16(), t(uncond))
    assert cfg16.dtype == torch.bfloat16


def test_heun_step_matches_jax():
    rng = np.random.default_rng(3)
    x, d1, d2 = (rng.standard_normal((1, 12, 16)).astype(np.float32) for _ in range(3))
    heun, jheun = diffusion_steps.HeunDiffusionStep(), jdiffusion_steps.HeunDiffusionStep()
    for sigma, sigma_next in ((0.9, 0.5), (0.4, 0.0)):
        for second in (None, d2):
            out = heun.step(t(x).bfloat16(), t(d1), sigma, sigma_next, None if second is None else t(second))
            ref = jheun.step(jnp.asarray(x, jnp.bfloat16), jnp.asarray(d1), sigma, sigma_next,
                             None if second is None else jnp.asarray(second))
            assert_bitwise(out, ref, f"heun {sigma} -> {sigma_next}, second eval {second is not None}")
        assert_bitwise(heun.predict(t(x), t(d1), sigma, sigma_next), jheun.predict(jnp.asarray(x), jnp.asarray(d1),
                                                                                   sigma, sigma_next))


def test_loop_helpers_match_jax():
    for steps, cutoff in ((3, 0.5), (10, 0.7), (30, 1.0), (7, 1 / 3)):
        ids, flags = denoise._stg_step_flags(steps, cutoff)
        jids, jflags = jdenoise._stg_step_flags(steps, cutoff)
        assert_bitwise(flags, jflags, f"stg flags {steps} {cutoff}")
    cfg = DenoiseLoopConfig(guider=CFGGuider(3.0), stg_scale=1.0, stg_blocks=(29,), cross_attn_scale=0.5)
    jcfg = jdenoise.DenoiseLoopConfig(guider=JCFGGuider(3.0), stg_scale=1.0, stg_blocks=(29,), cross_attn_scale=0.5)
    assert cfg.rows == jcfg.rows == 3
    assert_bitwise(denoise._ca_scales(cfg, 48), jdenoise._ca_scales(jcfg, 48))
    assert denoise._ca_scales(DenoiseLoopConfig(), 48) is None
    pert = denoise._build_perturbations(cfg, 3, batch=2)
    jpert = jdenoise._build_perturbations(jcfg, 3, batch=2)
    for block in (0, 29):
        assert pert.mask(PerturbationType.SKIP_VIDEO_SELF_ATTN, block).tolist() == np.asarray(
            jpert.mask(JPerturbationType.SKIP_VIDEO_SELF_ATTN, block)).tolist()
    assert pert.mask(PerturbationType.SKIP_VIDEO_SELF_ATTN, 29).tolist() == [1, 1, 1, 1, 0, 0]  # pass-major
    assert denoise._build_perturbations(DenoiseLoopConfig(), 1) is None
