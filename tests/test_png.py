"""The numpy+zlib PNG codec used for dataset and artifact images, checked
against its own round trip and against OpenCV's encoder and decoder."""

import numpy as np
import pytest

from romap_tpu.utils.png import read_png, write_png

RNG = np.random.default_rng(5)

IMAGES = {
    "rgb8": lambda: RNG.integers(0, 256, (37, 53, 3), dtype=np.uint8),
    "gray8": lambda: RNG.integers(0, 256, (41, 29), dtype=np.uint8),
    "gray16": lambda: RNG.integers(0, 65536, (23, 31), dtype=np.uint16),
}


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_png_round_trip_and_opencv_interop(kind, tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = IMAGES[kind]()
    # a smooth ramp too, so OpenCV's encoder picks its predictive filters
    ramp = (np.indices(img.shape[:2]).sum(0) * 3).astype(img.dtype)
    ramp = np.repeat(ramp[..., None], 3, 2) if img.ndim == 3 else ramp
    for a in (img, ramp):
        ours = str(tmp_path / "ours.png")
        write_png(ours, a)
        got = read_png(ours)
        assert got.dtype == a.dtype and got.shape == a.shape
        np.testing.assert_array_equal(got, a)
        # OpenCV reads ours (it returns BGR for colour)
        back = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back[..., ::-1] if a.ndim == 3 else back, a)
        # and we read OpenCV's, whatever row filters it chose
        theirs = str(tmp_path / "theirs.png")
        cv2.imwrite(theirs, a[..., ::-1] if a.ndim == 3 else a)
        np.testing.assert_array_equal(read_png(theirs), a)


def test_png_rejects_unsupported_images(tmp_path):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))
