"""The port's baseline JPEG decoder (ltx2_tpu_torch/utils/jpeg.py) against
PIL's decode (`Image.open(...).convert("RGB")`, libjpeg-turbo), bit for bit,
on files PIL writes here: qualities 50, 75, 92 and 100; 4:4:4, 4:2:2 and
4:2:0 subsampling and grayscale; sizes that are not whole MCUs (37x53,
17x9, and chroma planes of 2 columns or fewer, which libjpeg upsamples by
replication); restart intervals by rows and by blocks; optimized Huffman
tables; a frame with its DHT segments stripped (the Annex K.3 tables, as
MJPEG streams carry none); and the files it refuses by name (progressive,
CMYK, RGB-coded, 12-bit, arithmetic-coded, truncated). Tolerance: none,
the decoded bytes are equal.
"""

import io

import numpy as np
import pytest
from PIL import Image

from ltx2_tpu_torch.pipelines.common import read_image
from ltx2_tpu_torch.utils import jpeg
from tests.torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _image(h: int, w: int, seed: int, gray: bool = False) -> np.ndarray:
    """A smooth gradient with noise (what a camera frame is to the coder)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx + yy) * 128 / max(h + w, 1)], -1)
    pixels = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
    return pixels[..., 0] if gray else pixels


def _encode(pixels: np.ndarray, mode=None, **options) -> bytes:
    buf = io.BytesIO()
    image = Image.fromarray(pixels)
    (image.convert(mode) if mode else image).save(buf, "JPEG", **options)
    return buf.getvalue()


def _assert_decodes_as_pil(data: bytes) -> None:
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("quality", [50, 75, 92, 100])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "gray"])
def test_decoder_equals_pil(quality, sampling):
    for i, (h, w) in enumerate([(37, 53), (17, 9), (64, 96), (3, 2), (1, 1)]):
        pixels = _image(h, w, seed=quality + i, gray=sampling == "gray")
        options = {} if sampling == "gray" else {"subsampling": sampling}
        _assert_decodes_as_pil(_encode(pixels, quality=quality, **options))


@pytest.mark.parametrize("options", [{"restart_marker_rows": 1}, {"restart_marker_blocks": 3},
                                     {"optimize": True}, {"optimize": True, "restart_marker_blocks": 1}],
                         ids=["restart_rows", "restart_blocks", "optimize", "optimize_restart"])
def test_restarts_and_optimized_tables(options):
    for sampling in ("4:4:4", "4:2:0"):
        _assert_decodes_as_pil(_encode(_image(45, 70, seed=3), quality=85, subsampling=sampling, **options))
    _assert_decodes_as_pil(_encode(_image(45, 70, seed=4, gray=True), quality=85, **options))


def _strip_dht(data: bytes) -> bytes:
    out, pos = bytearray(data[:2]), 2
    while True:
        marker, length = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            return bytes(out + data[pos:])
        if marker != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length


def test_frame_without_huffman_tables_takes_annex_k():
    for sampling in ("4:2:2", "4:2:0"):
        data = _strip_dht(_encode(_image(40, 56, seed=5), quality=80, subsampling=sampling))
        assert b"\xff\xc4" not in data
        _assert_decodes_as_pil(data)
    # The standard tables are the ones PIL writes when it does not optimize.
    data = _encode(_image(16, 16, seed=6), quality=75)
    frame = jpeg.JPEGFrame(data)
    for (cls, slot), (counts, symbols) in jpeg.STANDARD_TABLES.items():
        assert frame.huff[(cls, slot)].lut == jpeg._Huffman(counts, symbols).lut


def test_refusals_name_the_format():
    pixels = _image(24, 32, seed=7)
    cases = {
        "progressive": _encode(pixels, progressive=True),
        "CMYK": _encode(pixels, mode="CMYK"),
    }
    data = bytearray(_encode(pixels, quality=90))
    sof = data.index(b"\xff\xc0")
    twelve = bytearray(data)
    twelve[sof + 4] = 12  # the frame's sample precision
    cases["12-bit"] = bytes(twelve)
    arith = bytearray(data)
    arith[sof + 1] = 0xC9
    cases["arithmetic-coded"] = bytes(arith)
    # No JFIF marker and an Adobe APP14 with transform 0: RGB-coded.
    app0 = data.index(b"\xff\xe0")
    app0_end = app0 + 2 + int.from_bytes(data[app0 + 2:app0 + 4], "big")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    cases["RGB-coded"] = bytes(data[:app0] + adobe + data[app0_end:])
    cases["truncated"] = bytes(data[:len(data) // 2])
    for name, payload in cases.items():
        with pytest.raises(ValueError, match=name):
            jpeg.decode_jpeg(payload)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def test_read_image_dispatches_a_jpeg_to_the_decoder(tmp_path):
    path = str(tmp_path / "still.jpg")
    pixels = _image(50, 66, seed=8)
    Image.fromarray(pixels).save(path, quality=88)
    np.testing.assert_array_equal(read_image(path), np.asarray(Image.open(path).convert("RGB")))
