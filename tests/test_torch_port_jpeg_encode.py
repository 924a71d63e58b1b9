"""The port's JPEG encoder (ltx2_tpu_torch/utils/jpeg.py `encode_jpeg`)
against PIL's `Image.fromarray(frame).save(buf, "JPEG", quality=q)`
(libjpeg-turbo), byte for byte (tolerance none), on the CPU:

- qualities 1, 50, 75, 92, 95 and 100 at 8x8, 33x47, 64x96 and 256x384
  (odd widths and heights: the edge replication, the MCUs' dummy blocks),
  on a noisy gradient and on uniform noise (long runs of ZRL codes, the
  largest coefficients, 0xFF bytes to stuff);
- sizes that leave partial MCUs every way (1x1, 9x17, 15x31, 17x9, 31x15,
  100x130);
- the quantization tables against the ones PIL writes, `encode_jpegs`
  against one call a frame, what the encoder refuses;
- the committed AVI's 9 frames (tests/fixtures_video) against the PIL
  SHA-256s recorded in media_io.json, which chip_smoke.py checks on the
  card's host.
"""

import hashlib
import io

import numpy as np
import pytest
from PIL import Image

from ltx2_tpu_torch.utils import jpeg
from tests import torch_port_media as media
from tests.torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _gradient(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx + yy) * 128 / max(h + w, 1)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _noise(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("quality", [1, 50, 75, 92, 95, 100])
@pytest.mark.parametrize("size", [(8, 8), (33, 47), (64, 96), (256, 384)])
def test_encode_jpeg_equals_pil(size, quality):
    for kind, make in (("gradient", _gradient), ("noise", _noise)):
        frame = make(*size, seed=size[0] + quality)
        got = jpeg.encode_jpeg(frame, quality)
        assert got == media.pil_jpeg(frame, quality), (kind, size, quality)


@pytest.mark.parametrize("size", [(1, 1), (9, 17), (15, 31), (17, 9), (31, 15), (100, 130)])
def test_partial_mcus(size):
    for seed in range(2):
        frame = _gradient(*size, seed=seed) if seed == 0 else _noise(*size, seed=seed)
        assert jpeg.encode_jpeg(frame) == media.pil_jpeg(frame, 92), (size, seed)


def test_flat_and_extreme_frames():
    """Flat frames (every AC zero, EOB right after the DC) and black/white
    checkerboards (the largest DC differences and AC magnitudes)."""
    yy, xx = np.mgrid[0:40, 0:56]
    checker = (((yy + xx) % 2) * 255).astype(np.uint8)
    for frame in (np.zeros((40, 56, 3), np.uint8), np.full((40, 56, 3), 255, np.uint8),
                  np.repeat(checker[..., None], 3, axis=2), np.stack([checker, 255 - checker, checker], -1)):
        for quality in (1, 92, 100):
            assert jpeg.encode_jpeg(frame, quality) == media.pil_jpeg(frame, quality)


@pytest.mark.parametrize("quality", [1, 10, 49, 50, 51, 92, 100])
def test_quant_tables_are_pils(quality):
    with Image.open(io.BytesIO(media.pil_jpeg(_gradient(16, 16, 0), quality))) as im:
        tables = im.quantization  # natural order (Pillow undoes the DQT segments' zigzag)
    ours = jpeg.quant_tables(quality)
    assert [list(ours[t]) for t in (0, 1)] == [list(tables[0]), list(tables[1])]


def test_encode_jpegs_and_refusals():
    frames = np.stack([_gradient(24, 40, s) for s in range(5)])
    assert jpeg.encode_jpegs(frames, 75) == [jpeg.encode_jpeg(f, 75) for f in frames]
    assert jpeg.encode_jpegs(frames[:1]) == [media.pil_jpeg(frames[0], 92)]
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            jpeg.encode_jpeg(bad)


def test_encoded_files_decode_as_pils():
    """What the encoder writes, the port's decoder reads as PIL does."""
    frame = _gradient(72, 104, 3)
    data = jpeg.encode_jpeg(frame)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_committed_avi_frames_match_the_recorded_pil_hashes():
    meta = media.committed_hashes()
    frames = media.avi_frames()
    assert media.sha256(frames) == meta["avi_frames_sha256"]
    got = [hashlib.sha256(b).hexdigest() for b in jpeg.encode_jpegs(frames, 92)]
    assert got == meta["jpeg_q92_sha256"] == [hashlib.sha256(media.pil_jpeg(f)).hexdigest() for f in frames]
