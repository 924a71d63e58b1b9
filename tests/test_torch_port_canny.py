"""The port's Canny steps (ltx2_tpu_torch/utils/canny.py) against OpenCV's
`cv2.resize(INTER_LANCZOS4)`, `cv2.cvtColor(BGR2GRAY)` and `cv2.Canny`
(aperture 3, L1 gradient), bit for bit (tolerance none), on the CPU:

- random and structured frames and the committed AVI's frames, resized
  288x432 -> 256x384 and -> 512x768, 480x640 -> 512x768, 100x130 -> 64x96,
  an unchanged size and a stretch (37x53 -> 70x20), with OpenCV's optimized
  paths on and off; thresholds 100 / 200, 20 / 60, fractional (cvFloor),
  swapped and equal;
- `preprocess_canny` against the JAX package's on the committed AVI with
  cv2 present (both read the frames through `cv2.VideoCapture`), and
  `save_control`'s Canny `.control.avi` against the JAX package's bytes;
- the Canny signal of the committed AVI's frames (as PIL and the port
  decode them) against the cv2 SHA-256s in media_io.json, and with cv2
  hidden `preprocess_canny` at 256x384x121 and its `.control.avi` against
  the recorded hashes: what chip_smoke.py checks on the card's host.
"""

import shutil
import sys

import numpy as np
import pytest

from ltx2_tpu.pipelines import ic_lora as jic
from ltx2_tpu_torch.pipelines import ic_lora
from ltx2_tpu_torch.utils.canny import bgr_to_gray, canny, resize_lanczos4
from tests import torch_port_media as media
from tests.torch_port_util import one_intra_op_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

RESIZES = [((288, 432), (256, 384)), ((288, 432), (512, 768)), ((480, 640), (512, 768)), ((100, 130), (64, 96)),
           ((64, 96), (64, 96)), ((37, 53), (70, 20))]


def _frame(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "blocks":
        yy, xx = np.mgrid[0:h, 0:w]
        return np.stack([(yy * 3 + xx) % 256, (xx * 5) % 256, ((yy // 8 + xx // 8) % 2) * 200], -1).astype(np.uint8)
    frame = media.avi_frames()[seed % 9][..., ::-1]  # BGR, as cv2 reads it
    return cv2.resize(np.ascontiguousarray(frame), (w, h), interpolation=cv2.INTER_AREA)


@pytest.mark.parametrize("optimized", [True, False])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_gray_canny_equal_opencv(src, dst, optimized):
    was = cv2.useOptimized()
    cv2.setUseOptimized(optimized)
    try:
        for seed, kind in enumerate(("noise", "blocks", "fixture")):
            frame = _frame(kind, *src, seed=seed)
            resized = cv2.resize(frame, (dst[1], dst[0]), interpolation=cv2.INTER_LANCZOS4)
            np.testing.assert_array_equal(resize_lanczos4(frame, dst[1], dst[0]), resized)
            gray = cv2.cvtColor(resized, cv2.COLOR_BGR2GRAY)
            np.testing.assert_array_equal(bgr_to_gray(resized), gray)
            for low, high in ((100, 200), (20, 60)):
                np.testing.assert_array_equal(canny(gray, low, high), cv2.Canny(gray, low, high), (kind, low, high))
    finally:
        cv2.setUseOptimized(was)


def test_thresholds():
    gray = cv2.cvtColor(cv2.resize(_frame("fixture", 120, 160, 4), (150, 110), interpolation=cv2.INTER_LANCZOS4),
                        cv2.COLOR_BGR2GRAY)
    for low, high in ((20.7, 60.2), (60, 20), (35, 35), (0, 0), (200.9, 400.1), (1000, 2000)):
        np.testing.assert_array_equal(canny(gray, low, high), cv2.Canny(gray, low, high), (low, high))
    resized = resize_lanczos4(np.zeros((9, 13), np.uint8) + 77, 20, 5)  # one channel
    np.testing.assert_array_equal(resized, cv2.resize(np.zeros((9, 13), np.uint8) + 77, (20, 5),
                                                      interpolation=cv2.INTER_LANCZOS4))


@pytest.mark.parametrize("size,thresholds", [((32, 48), (100, 200)), ((64, 96), (20, 60)), ((24, 40), (30, 90))])
def test_preprocess_canny_matches_jax_with_opencv(size, thresholds):
    """Both read the committed AVI through cv2.VideoCapture; 12 frames asked
    of its 9, the last repeated."""
    path = str(media.AVI)
    got = ic_lora.preprocess_canny(path, *size, 12, *thresholds)
    ref = jic.preprocess_canny(path, *size, 12, *thresholds)
    assert got.shape == (12, *size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_committed_avi_signal_matches_the_recorded_opencv_hashes():
    meta = media.committed_hashes()
    frames = media.avi_frames()
    for (low, high), rec in zip(media.CANNY_THRESHOLDS, meta["canny"].values()):
        signal = np.stack([np.repeat(canny(bgr_to_gray(resize_lanczos4(f[..., ::-1], media.CANNY_SIZE[1],
                                                                        media.CANNY_SIZE[0])), low, high)[..., None],
                                     3, axis=2) for f in frames])
        assert media.sha256(signal) == rec["sha256_uint8"] == media.sha256(media.cv2_canny(frames, low, high))
        assert int((signal[..., 0] > 0).sum()) == rec["edge_pixels"]


def test_signal_and_control_avi_without_opencv(tmp_path, monkeypatch):
    """Without OpenCV (as chip_smoke.py runs it on the card): the committed
    AVI read by the port's readers, the Canny at stage 1's 256x384 over 121
    frames, and save_control's .control.avi, against the recorded hashes
    (cv2's Canny of the same frames, the JAX writer's bytes of that
    signal)."""
    meta = media.committed_hashes()
    control = tmp_path / "control.avi"
    shutil.copy(media.AVI, control)
    monkeypatch.setitem(sys.modules, "cv2", None)
    low, high = media.CANNY_THRESHOLDS[0]
    signal = ic_lora.preprocess_canny(str(control), *media.CANNY_SIZE, media.CONTROL_FRAMES, low, high)
    assert media.sha256(signal[:9]) == meta["canny"][f"{low}_{high}"]["sha256_uint8"]
    assert (signal[9:] == signal[8]).all()
    vc = ic_lora.VideoCondition(str(control), control_type=ic_lora.ControlType.CANNY, canny_low=low, canny_high=high,
                                save_control=True)
    ic_lora.create_video_conditionings([vc], lambda video: video, *media.CANNY_SIZE, media.CONTROL_FRAMES)
    assert media.file_sha256(str(control) + ".control.avi") == meta["control_avi_20_60_sha256"]


def test_save_control_canny_matches_jax(tmp_path):
    """With OpenCV: the JAX package's `.control.avi` of a Canny control,
    byte for byte."""
    control = str(tmp_path / "control.avi")
    shutil.copy(media.AVI, control)
    jvc = jic.VideoCondition(control, control_type=jic.ControlType.CANNY, canny_low=30, canny_high=90,
                             save_control=True)
    jic.create_video_conditionings([jvc], lambda video: video, 48, 64, 17)
    with open(control + ".control.avi", "rb") as fh:
        ref = fh.read()
    vc = ic_lora.VideoCondition(control, control_type=ic_lora.ControlType.CANNY, canny_low=30, canny_high=90,
                                save_control=True)
    ic_lora.create_video_conditionings([vc], lambda video: video, 48, 64, 17)
    with open(control + ".control.avi", "rb") as fh:
        assert fh.read() == ref
