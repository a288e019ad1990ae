"""The port's bicubic resize (`utils/image_io.py::resize_bicubic`, C++ in
`csrc/host/image_io.cpp`) and its plain numpy int64 version `resize_ref`
against PIL's `Image.resize` (bicubic, the default filter), bit for bit:
down, up, to and from 1 pixel, extreme ratios, width only, height only,
identity, and grey / RGBA layouts. About 3 s."""

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu_torch.utils import image_io

CASES = {  # name: ((H, W), (new W, new H))
    "down": ((37, 53), (16, 16)),
    "down_paired_crop": ((768, 1024), (683, 512)),
    "up": ((20, 20), (47, 31)),
    "up_odd": ((300, 200), (512, 341)),
    "down_333x250": ((512, 512), (333, 250)),
    "up_600x400_to_1024": ((400, 600), (1024, 1024)),
    "to_1px": ((5, 7), (1, 1)),
    "from_1px": ((1, 1), (7, 3)),
    "extreme_down": ((7, 1000), (3, 3)),
    "extreme_up": ((3, 2), (300, 5)),
    "width_only": ((40, 40), (17, 40)),
    "height_only": ((40, 40), (40, 13)),
    "identity": ((9, 7), (7, 9)),
}


@pytest.fixture(scope="module", autouse=True)
def lib():
    return image_io.get_lib()


@pytest.mark.parametrize("name", list(CASES))
def test_resize_matches_pil_and_plain(name):
    (h, w), size = CASES[name]
    img = np.random.default_rng(len(name)).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size))
    got = image_io.resize_bicubic(img, size)
    assert got.shape == want.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.resize_ref(img, size), want)
    if size == (w, h):
        assert got is not img and np.array_equal(got, img)


@pytest.mark.parametrize("channels", [1, 4], ids=["grey", "rgba"])
def test_other_layouts(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (33, 21) if channels == 1 else (33, 21, 4), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img, mode="L" if channels == 1 else "RGBX").resize((10, 50)))
    np.testing.assert_array_equal(image_io.resize_bicubic(img, (10, 50)), want)
    np.testing.assert_array_equal(image_io.resize_ref(img, (10, 50)), want)


def test_bad_arguments_raise():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(TypeError):
        image_io.resize_bicubic(img.astype(np.float32), (2, 2))
    with pytest.raises(ValueError):
        image_io.resize_bicubic(img, (0, 2))
