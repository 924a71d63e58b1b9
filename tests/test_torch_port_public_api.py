"""The rest of the JAX package's public API in the port, held against it on
the CPU: generation snapshots written by one package and read by the other
(both ways, video and audio states), `LinearQuadraticScheduler`,
`BetaScheduler` and `flux_time_shift` (1e-6), `DeterministicNoiser` on
handed-in noise (and its own fixed stream), the seven `create_*_pipeline`
factories (their pipelines and default configs against JAX's), and
`check_config_value`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu import core as jcore
from ltx2_tpu.components import noisers as jnoisers
from ltx2_tpu.components import schedulers as jschedulers
from ltx2_tpu.pipelines import distilled as jdistilled
from ltx2_tpu.pipelines import ic_lora as jic_lora
from ltx2_tpu.pipelines import keyframe_interpolation as jkeyframe
from ltx2_tpu.pipelines import one_stage as jone_stage
from ltx2_tpu.pipelines import retake as jretake
from ltx2_tpu.pipelines import text_to_video as jtext_to_video
from ltx2_tpu.pipelines import ti2vid_hq as jti2vid_hq
from ltx2_tpu.types import LatentState as JLatentState
from ltx2_tpu.utils import checkpointing as jcheckpointing
from ltx2_tpu_torch import core
from ltx2_tpu_torch.components import noisers, schedulers
from ltx2_tpu_torch.models.transformer.model import LTXModel
from ltx2_tpu_torch.pipelines import distilled, ic_lora, keyframe_interpolation, one_stage, retake, text_to_video
from ltx2_tpu_torch.pipelines import ti2vid_hq
from ltx2_tpu_torch.types import LatentState
from ltx2_tpu_torch.utils import checkpointing
from tests.torch_port_util import CFG
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

TOL_SIGMAS = 1e-6


def _state(seed, tokens):
    rng = np.random.default_rng(seed)
    return {"latent": rng.standard_normal((1, tokens, 16)).astype(np.float32),
            "denoise_mask": rng.uniform(0, 1, (1, tokens)).astype(np.float32),
            "positions": rng.standard_normal((1, 3, tokens, 2)).astype(np.float32),
            "clean_latent": rng.standard_normal((1, tokens, 16)).astype(np.float32)}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("audio", [False, True])
def test_generation_state_files_are_interchangeable(tmp_path, writer, audio):
    video, sound = _state(0, 12), _state(1, 5) if audio else None
    sigmas = np.array([1.0, 0.9, 0.5, 0.2, 0.0], np.float32)
    path = str(tmp_path / "state")  # no suffix: written and read at exactly this path
    if writer == "jax":
        jcheckpointing.save_generation_state(path, JLatentState(**{k: jnp.asarray(v) for k, v in video.items()}),
                                             jnp.asarray(sigmas), 2, None if sound is None else
                                             JLatentState(**{k: jnp.asarray(v) for k, v in sound.items()}))
    else:
        checkpointing.save_generation_state(path, LatentState(**{k: torch.from_numpy(v) for k, v in video.items()}),
                                            torch.from_numpy(sigmas), 2, None if sound is None else
                                            LatentState(**{k: torch.from_numpy(v) for k, v in sound.items()}))
    jv, ja, jsig, jstep = jcheckpointing.load_generation_state(path)
    pv, pa, psig, pstep = checkpointing.load_generation_state(path)
    assert jstep == pstep == 2
    np.testing.assert_array_equal(psig.numpy(), np.asarray(jsig))
    np.testing.assert_array_equal(psig.numpy(), sigmas[2:])
    for want, jst, pst in ((video, jv, pv), (sound, ja, pa)):
        if want is None:
            assert jst is None and pst is None
            continue
        for k, v in want.items():
            np.testing.assert_array_equal(getattr(pst, k).numpy(), v)
            np.testing.assert_array_equal(np.asarray(getattr(jst, k)), v)


def test_bf16_state_saves_as_float32(tmp_path):
    video = {k: torch.from_numpy(v) for k, v in _state(2, 4).items()}
    video["latent"] = video["latent"].bfloat16()
    checkpointing.save_generation_state(str(tmp_path / "s.npz"), LatentState(**video), [1.0, 0.0], 0)
    loaded, _, _, _ = checkpointing.load_generation_state(str(tmp_path / "s.npz"))
    assert loaded.latent.dtype == torch.float32 and torch.equal(loaded.latent, video["latent"].float())


@pytest.mark.parametrize("steps", [1, 2, 3, 8, 30, 50])
def test_schedulers_match_jax(steps):
    for port, ref, kw in ((schedulers.LinearQuadraticScheduler(), jschedulers.LinearQuadraticScheduler(), {}),
                          (schedulers.LinearQuadraticScheduler(), jschedulers.LinearQuadraticScheduler(),
                           {"threshold_noise": 0.05, "linear_steps": max(1, steps // 3)}),
                          (schedulers.BetaScheduler(), jschedulers.BetaScheduler(), {}),
                          (schedulers.BetaScheduler(), jschedulers.BetaScheduler(), {"alpha": 0.5, "beta": 0.7})):
        got, want = port.execute(steps, **kw), ref.execute(steps, **kw)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= TOL_SIGMAS
    for mu, sigma, t in ((2.37, 1.0, 0.3), (0.5, 2.0, 0.9), (1.0, 1.0, 1.0)):
        assert abs(schedulers.flux_time_shift(mu, sigma, t) - jschedulers.flux_time_shift(mu, sigma, t)) <= 1e-12


def test_deterministic_noiser():
    state = {k: torch.from_numpy(v) for k, v in _state(3, 10).items()}
    noise = np.random.default_rng(4).standard_normal((1, 10, 16)).astype(np.float32)
    port = noisers.DeterministicNoiser(seed=9)
    got = port(None, LatentState(**state), 0.8, noise=torch.from_numpy(noise))
    # The JAX noiser's blend, on the same noise.
    jstate = JLatentState(**{k: jnp.asarray(v.numpy()) for k, v in state.items()})
    want = jnoisers._blend(jstate, jnp.asarray(noise), 0.8)
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), rtol=0, atol=1e-6)
    # Its own stream: the same whatever the generator, another for another seed.
    a = port(torch.Generator().manual_seed(1), LatentState(**state)).latent
    b = port(torch.Generator().manual_seed(2), LatentState(**state)).latent
    c = noisers.DeterministicNoiser(seed=10)(None, LatentState(**state)).latent
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert jnoisers.DeterministicNoiser(seed=9).seed == port.seed


FACTORIES = [
    (distilled.create_distilled_pipeline, distilled.DistilledPipeline, distilled.DistilledConfig,
     jdistilled.create_distilled_pipeline, jdistilled.DistilledConfig),
    (one_stage.create_one_stage_pipeline, one_stage.OneStagePipeline, one_stage.OneStageCFGConfig,
     jone_stage.create_one_stage_pipeline, jone_stage.OneStageCFGConfig),
    (text_to_video.create_text_to_video_pipeline, text_to_video.TextToVideoPipeline, text_to_video.TextToVideoConfig,
     jtext_to_video.create_text_to_video_pipeline, jtext_to_video.TextToVideoConfig),
    (ti2vid_hq.create_ti2vid_hq_pipeline, ti2vid_hq.TI2VidHQPipeline, ti2vid_hq.TI2VidHQConfig,
     jti2vid_hq.create_ti2vid_hq_pipeline, jti2vid_hq.TI2VidHQConfig),
    (ic_lora.create_ic_lora_pipeline, ic_lora.ICLoraPipeline, ic_lora.ICLoraConfig,
     jic_lora.create_ic_lora_pipeline, jic_lora.ICLoraConfig),
    (keyframe_interpolation.create_keyframe_pipeline, keyframe_interpolation.KeyframeInterpolationPipeline,
     keyframe_interpolation.KeyframeInterpolationConfig, jkeyframe.create_keyframe_pipeline,
     jkeyframe.KeyframeInterpolationConfig),
    (retake.create_retake_pipeline, retake.RetakePipeline, retake.RetakeConfig, jretake.create_retake_pipeline,
     jretake.RetakeConfig),
]


# JAX config fields the port's configs leave out, unused there: the distilled
# stages run fixed sigmas (no token shift), and the vocoder's own rate sets
# the .wav's (no audio_output_sample_rate).
UNUSED_JAX_FIELDS = {"DistilledConfig": {"token_dependent_shift"}, "ICLoraConfig": {"token_dependent_shift"},
                     "OneStageCFGConfig": {"audio_output_sample_rate"}}


@pytest.mark.parametrize("factory,cls,config,jfactory,jconfig", FACTORIES, ids=lambda f: getattr(f, "__name__", ""))
def test_pipeline_factories(factory, cls, config, jfactory, jconfig):
    """Each factory builds its pipeline on the modules given; the pipeline's
    default config holds the JAX config's values, field by field (but the
    fields the port leaves out, UNUSED_JAX_FIELDS)."""
    dit = LTXModel(dataclasses.replace(CFG, num_layers=0), device="meta")
    pipe = factory(transformer=dit)
    assert type(pipe) is cls and pipe.transformer is dit
    assert factory.__name__ == jfactory.__name__
    ours, theirs = dataclasses.asdict(config()), dataclasses.asdict(jconfig())
    shared = sorted(set(ours) & set(theirs))
    assert set(theirs) - set(ours) == UNUSED_JAX_FIELDS.get(config.__name__, set()) and set(ours) <= set(theirs)
    for name in shared:
        mine, ref = ours[name], theirs[name]
        if isinstance(ref, (list, tuple)) or hasattr(ref, "dtype"):
            np.testing.assert_array_equal(np.asarray(mine), np.asarray(ref), err_msg=name)
        elif not isinstance(ref, dict):
            assert mine == ref or str(mine) == str(ref), (name, mine, ref)


def test_check_config_value():
    config = {"a": 1, "b": "x"}
    for key, expected in (("a", 1), ("b", "x")):
        core.check_config_value(config, key, expected)
        jcore.check_config_value(config, key, expected)
    for key, expected in (("a", 2), ("c", None), ("c", 3)):
        errors = []
        for fn in (core.check_config_value, jcore.check_config_value):
            try:
                fn(config, key, expected)
                errors.append(None)
            except ValueError as err:
                errors.append(str(err))
        assert errors[0] == errors[1]
        assert (errors[0] is None) == (key == "c" and expected is None)


def test_jax_noise_is_not_the_port_stream():
    """DeterministicNoiser's draws are torch's: documented as differing from
    JAX's PRNG at the same seed (the tests hand noise in instead)."""
    state = {k: torch.from_numpy(v) for k, v in _state(5, 6).items()}
    state["denoise_mask"] = torch.ones_like(state["denoise_mask"])
    port = noisers.DeterministicNoiser(seed=42)(None, LatentState(**state)).latent.numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (1, 6, 16), jnp.float32))
    assert not np.allclose(port, want)
