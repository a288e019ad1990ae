"""The port's PNG unfilter (`utils/image_io.py::png_unfilter`, C++ in
`csrc/host/image_io.cpp`) against its plain numpy version, for each filter
type and a mix, at 1, 3 and 4 bytes per pixel; an unknown filter type
raises. About 2 s."""

import numpy as np
import pytest

from reflectionflow_tpu_torch.utils import image_io


@pytest.fixture(scope="module", autouse=True)
def lib():
    return image_io.get_lib()


@pytest.mark.parametrize("bpp", [1, 3, 4])
@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_unfilter_matches_plain(filters, bpp):
    h, w = 13, 17
    rng = np.random.default_rng(bpp)
    raw = rng.integers(0, 256, (h, w * bpp + 1), dtype=np.uint8)
    kinds = ["none", "sub", "up", "average", "paeth"]
    raw[:, 0] = rng.integers(0, 5, h) if filters == "mixed" else kinds.index(filters)
    want = image_io.png_unfilter_ref(raw, h, w * bpp, bpp)
    np.testing.assert_array_equal(image_io.png_unfilter(raw, h, w * bpp, bpp), want)


def test_unknown_filter_raises():
    raw = np.zeros((2, 7), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="filter"):
        image_io.png_unfilter(raw, 2, 6, 3)
    with pytest.raises(ValueError, match="filter"):
        image_io.png_unfilter_ref(raw, 2, 6, 3)
