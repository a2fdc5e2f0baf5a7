"""The port's image gather against the JAX package's Pallas kernel
(``pallas_gather.gather_image``, run in interpret mode off a TPU) and its
one-hot GEMM form (``mxu.gather_image(exact=False)``).  All are bf16
lookups, so they must agree bit for bit."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.ops import mxu, pallas_gather
from gennbv_tpu_torch.ops import gather, kernels


def _image(rng, n, h, w):
    """Depth-like values plus the edge cases of the rollout's z-buffers:
    exact bf16 rounding ties, negatives, zero and exactly depth_max."""
    img = rng.uniform(0.1, 30.0, (n, h, w)).astype(np.float32)
    flat = img.reshape(n, -1)
    # bf16 keeps 8 significant bits: 1 + 2^-8 (and 3 * 2^-8 + 1) sit on
    # rounding ties, which round to even
    ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, 2 + 2 ** -7, -(1 + 2 ** -8),
                     -3.7, 0.0, -0.0, 50.0, 49.995, 1e-30], np.float32)
    flat[:, : len(ties)] = ties
    return img


def _indices(rng, n, q, h, w):
    vi = rng.integers(0, h, (n, q)).astype(np.int32)
    ui = rng.integers(0, w, (n, q)).astype(np.int32)
    vi[:, :10], ui[:, :10] = 0, np.arange(10)      # hit every special value
    return vi, ui


@pytest.mark.parametrize("h,w,q", [(16, 16, 40), (48, 64, 700), (128, 128, 1100)])
def test_single_image_matches_pallas_and_mxu(h, w, q):
    rng = np.random.default_rng(h + q)
    img = _image(rng, 1, h, w)[0]
    vi, ui = (a[0] for a in _indices(rng, 1, q, h, w))
    want = np.asarray(pallas_gather.gather_image(
        jnp.asarray(img), jnp.asarray(vi), jnp.asarray(ui)))
    want_mxu = np.asarray(mxu.gather_image(
        jnp.asarray(img), jnp.asarray(vi), jnp.asarray(ui), exact=False))
    np.testing.assert_array_equal(want, want_mxu)
    for fn in (gather.gather_image_ref, gather.gather_image):
        got = fn(*(torch.from_numpy(a)[None] for a in (img, vi, ui)))
        assert got.dtype == torch.float32 and got.shape == (1, q)
        np.testing.assert_array_equal(got[0].numpy(), want)
    assert want[7] == 50.0 and want[2] == 2.0 and want[0] == 1.0


def test_batched_matches_vmapped_pallas():
    rng = np.random.default_rng(1)
    n, h, w, q = 3, 32, 48, 530            # q > 512 exercises the padding
    img = _image(rng, n, h, w)
    vi, ui = _indices(rng, n, q, h, w)
    args = tuple(map(jnp.asarray, (img, vi, ui)))
    want = np.asarray(jax.vmap(pallas_gather.gather_image)(*args))
    want_mxu = np.asarray(jax.vmap(
        lambda i, v, u: mxu.gather_image(i, v, u, exact=False))(*args))
    np.testing.assert_array_equal(want, want_mxu)
    before = kernels.launches()["gather_image"]
    got = gather.gather_image(*map(torch.from_numpy, (img, vi, ui)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert kernels.launches()["gather_image"] == before, \
        "the CPU path launches nothing"


def test_wrapper_rejects_bad_input():
    img = torch.zeros(2, 8, 8)
    vi = torch.zeros(2, 5, dtype=torch.int32)
    with pytest.raises(TypeError):
        gather.gather_image(img.double(), vi, vi)
    with pytest.raises(TypeError):
        gather.gather_image(img, vi.long(), vi)
    with pytest.raises(ValueError):
        gather.gather_image(img, vi[:1], vi[:1])           # batch mismatch
    with pytest.raises(ValueError):
        gather.gather_image(img, vi, vi[:, :4])            # vi/ui mismatch
    with pytest.raises(ValueError):
        gather.gather_image(img[:, :, ::2], vi, vi)        # not contiguous
    with pytest.raises(ValueError):
        gather.gather_image(img, vi.to("meta"), vi)        # mixed devices
    with pytest.raises(ValueError, match="no kernel"):
        gather.gather_image(img.to("meta"), vi.to("meta"), vi.to("meta"))



@pytest.mark.parametrize("q,offset", [(531, 0), (8001, 0), (528, 1), (8000, 3)])
def test_ragged_q_and_offset_views_match_pallas(q, offset):
    """A q that is not a multiple of the kernel's vector width, and index
    arrays that are contiguous views off 16-byte alignment (``buf[k:]``):
    the wrapper's geometry takes the scalar path for both, and its result
    equals the vmapped Pallas kernel's (interpret mode) bit for bit."""
    rng = np.random.default_rng(q + offset)
    n, h, w = 2, 40, 56
    img = _image(rng, n, h, w)
    vi, ui = _indices(rng, n, q, h, w)
    want = np.asarray(jax.vmap(pallas_gather.gather_image)(
        *map(jnp.asarray, (img, vi, ui))))

    def view(a):
        buf = torch.zeros(a.size + offset, dtype=torch.int32)
        buf[offset:] = torch.from_numpy(a.reshape(-1))
        return buf[offset:].view(n, q)

    tvi, tui = view(vi), view(ui)
    assert tvi.is_contiguous() and (tvi.data_ptr() % 16 != 0) == (offset % 4 != 0)
    geo = gather.launch_geometry(n, q, tvi.data_ptr(), tui.data_ptr())
    assert geo.path == "scalar"
    got = gather.gather_image(torch.from_numpy(img), tvi, tui)
    np.testing.assert_array_equal(got.numpy(), want)
