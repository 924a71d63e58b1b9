"""The options of the port's video denoise loop against the JAX package's
(`ltx2_tpu/pipelines/denoise.py::make_video_denoise_loop`), in float32 on
the CPU: the 2-layer parity DiT on random weights, 12 tokens, 3 steps down
to sigma 0, the same noise and contexts, to 1e-4 of max|latent|
(`assert_close`). Each case is one option alone or a combination the JAX
loop treats specially, so that each part fails its case when removed:

- STG alone (rows [cond, stg]) and with CFG*, `stg_blocks` and a cutoff of
  0.5 (the flags of 3 steps are 1, 0, 0) under per-token timesteps: the
  pass-major rows [cond, uncond, stg] and the cutoff flags;
- the guiders: the variance-rescaled CFG, APG with and without its norm
  clamp, the stateful APG with momentum (its carry), also under Heun and
  STG (the corrector reads the carry, does not advance it);
- Heun: with CFG, without guidance, with CFG* and STG (the corrector runs
  no STG row); GE momentum;
- guidance reuse (`cfg_interval` 2: full, reduced, full) with CFG*, and
  with APG, STG and Heun (the corrector takes the step's delta).

The refusals: `cfg_interval` < 1, the stateful APG with reuse, a mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx2_tpu_torch.components.guiders import CFGGuider, StatefulAPGGuider
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from tests.torch_port_util import CFG, assert_close, run_loops, stacked_dit_tree
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

OFF = ("CFGGuider", {"scale": 1.0})
CFG3 = ("CFGGuider", {"scale": 3.0})
STAR = ("CFGStarRescalingGuider", {"scale": 3.0})
APG = ("LtxAPGGuider", {"scale": 3.0, "eta": 0.5})
APG_CLAMP = ("LtxAPGGuider", {"scale": 3.0, "eta": 0.5, "norm_threshold": 1.0})
STATEFUL = ("StatefulAPGGuider", {"scale": 3.0, "eta": 0.5, "norm_threshold": 5.0, "momentum": 0.5})
HEUN = {"sampler": "heun"}

# case -> (guider, loop options, run_loops keywords)
CASES = {
    "stg": (OFF, {"stg_scale": 1.0}, {}),
    "stg_blocks_cutoff": (STAR, {"stg_scale": 1.0, "stg_blocks": (1,), "stg_cutoff": 0.5}, {"per_token": True}),
    "rescaled_cfg": (("RescaledCFGGuider", {"scale": 3.0, "rescale": 0.7}), {}, {}),
    "apg": (APG, {}, {}),
    "apg_norm_clamp": (APG_CLAMP, {}, {}),
    "stateful_apg_momentum": (STATEFUL, {}, {}),
    "stateful_apg_heun_stg": (STATEFUL, {**HEUN, "stg_scale": 1.0}, {}),
    "heun": (CFG3, HEUN, {}),
    "heun_no_guidance": (OFF, HEUN, {}),
    "heun_stg": (STAR, {**HEUN, "stg_scale": 1.0}, {"per_token": True}),
    "ge": (CFG3, {"ge_gamma": 0.5}, {}),
    "reuse_cfg_star": (STAR, {"cfg_interval": 2}, {}),
    "reuse_apg_stg_heun": (APG_CLAMP, {**HEUN, "stg_scale": 1.0, "cfg_interval": 2}, {}),
}


@pytest.fixture(scope="module")
def weights():
    tree = stacked_dit_tree()
    return jax.tree_util.tree_map(jnp.asarray, tree), dit_from_numpy(tree, CFG)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_option_matches_jax(weights, case):
    guider, opts, kwargs = CASES[case]
    out, ref = run_loops(*weights, guider, opts, **kwargs)
    assert np.isfinite(out).all()
    assert_close(out, ref, msg=case)


# option -> (guider, loop options) whose result must differ from the same
# run without the option: each parity case above exercises its option.
MOVES = {
    "stg_cutoff": ((STAR, {"stg_scale": 1.0, "stg_cutoff": 0.5}), (STAR, {"stg_scale": 1.0})),
    "apg_norm_clamp": ((APG_CLAMP, {}), (APG, {})),
    "apg_momentum": ((STATEFUL, {}), (("StatefulAPGGuider", {**STATEFUL[1], "momentum": 0.0}), {})),
    "ge": ((CFG3, {"ge_gamma": 0.5}), (CFG3, {})),
    "heun_corrector_no_stg": ((STAR, {**HEUN, "stg_scale": 1.0}), (STAR, {"stg_scale": 1.0})),
    "cfg_interval": ((STAR, {"cfg_interval": 2}), (STAR, {})),
}


@pytest.mark.parametrize("option", sorted(MOVES))
def test_loop_option_moves_the_result(weights, option):
    (g1, o1), (g0, o0) = MOVES[option]
    with_option, _ = run_loops(*weights, g1, o1, port_only=True)
    without, _ = run_loops(*weights, g0, o0, port_only=True)
    assert np.abs(with_option - without).max() > 1e-3 * np.abs(without).max(), option


def test_loop_refusals():
    with pytest.raises(ValueError, match="cfg_interval must be >= 1"):
        make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=CFGGuider(3.0), cfg_interval=0))
    with pytest.raises(ValueError, match="APG momentum"):
        make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=StatefulAPGGuider(3.0, 0.5, momentum=0.5),
                                                       cfg_interval=2))
    with pytest.raises(NotImplementedError, match="parallelism"):  # guidance reuse under PP, as in JAX
        make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=CFGGuider(3.0), cfg_interval=2), pipeline_axis="pipe")
    # Reuse without CFG is no reuse; the stateful APG at scale 0 is off.
    make_video_denoise_loop(CFG, DenoiseLoopConfig(cfg_interval=3))
    make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=StatefulAPGGuider(0.0, 0.5), cfg_interval=2))
