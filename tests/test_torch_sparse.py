"""The ``repro_torch.sparse`` facade, on the CPU (``device="cpu"``).

Mirrors the facade checks of the JAX package: ``spmm(A, b)`` against
``A.dense() @ b``, ``bspmm``, ``@`` and ``coo()``.  It also holds the rules
that keep the card honest: without ``device="cpu"`` the entry points need a
CUDA device and raise without one, an impl runs only on its own device, a
failed kernel build raises, and so does a nonzero launch status.
Tolerance: max |diff| <= 1e-5 * max(1, max |ref|) against fp64 dense.
"""
import numpy as np
import pytest
import torch

import repro_torch.sparse as sp
from repro_torch.errors import DispatchError, KernelLoweringError, PlanBuildError
from repro_torch.kernels import _build
from conftest import make_sparse

TOL = 1e-5


def _close(got, want):
    got = got.numpy().astype(np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.fixture
def matrix():
    rng = np.random.RandomState(0)
    a, rows, cols, vals = make_sparse(rng, 140, 110, 0.06, n_dense_rows=5)
    return a, rows, cols, vals, sp.from_coo(rows, cols, vals, a.shape,
                                            device="cpu")


def test_spmm_matches_dense(matrix):
    a, _, _, _, A = matrix
    b = np.random.RandomState(1).randn(110, 33).astype(np.float32)
    want = A.dense() @ b.astype(np.float64)
    assert np.array_equal(A.dense(), a.astype(np.float64))
    _close(sp.spmm(A, torch.from_numpy(b)), want)
    _close(sp.spmm(A, b), want)  # a numpy operand is copied to A's device
    _close(A @ torch.from_numpy(b), want)


def test_bspmm_matches_per_batch_spmm(matrix):
    a, _, _, _, A = matrix
    bb = torch.from_numpy(
        np.random.RandomState(2).randn(4, 110, 20).astype(np.float32))
    out = sp.bspmm(A, bb)
    assert out.shape == (4, 140, 20)
    for i in range(4):
        _close(out[i], a.astype(np.float64) @ bb[i].numpy().astype(np.float64))
        assert torch.equal(out[i], sp.spmm(A, bb[i].contiguous()))
    with pytest.raises(ValueError, match="batch"):
        sp.bspmm(A, bb[0])


def test_coo_and_metadata(matrix):
    a, rows, cols, vals, A = matrix
    r, c, v = A.coo()
    assert np.array_equal(r, rows) and np.array_equal(c, cols)
    assert np.array_equal(v, vals)
    assert A.shape == a.shape and A.nnz == rows.size
    assert A.device.type == "cpu" and A.plan.config.impl == "torch"
    assert "impl='torch'" in repr(A)


def test_from_plan_adopts_a_prepared_plan(matrix):
    _, _, _, _, A = matrix
    B = sp.from_plan(A.plan)
    b = torch.ones(110, 4)
    assert torch.equal(sp.spmm(B, b), sp.spmm(A, b))
    with pytest.raises(TypeError):
        sp.spmm(object(), b)


def test_config_overrides_reach_the_plan():
    rng = np.random.RandomState(3)
    a, rows, cols, vals = make_sparse(rng, 64, 64, 0.1)
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu", alpha=1.0)
    assert not A.plan.has_core and A.plan.config.alpha == 1.0
    with pytest.raises(ValueError, match="not both"):
        sp.from_coo(rows, cols, vals, a.shape, device="cpu",
                    config=sp.SpmmConfig(impl="torch"), alpha=1.0)


def test_from_coo_without_device_needs_a_card(monkeypatch):
    """The default device is the card: with none it raises, never falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = np.array([0, 1]), np.array([1, 0]), np.array([1.0, 2.0])
    with pytest.raises(PlanBuildError, match="CUDA device"):
        sp.from_coo(*rows, (2, 2))
    with pytest.raises(PlanBuildError):
        sp.from_coo(*rows, (2, 2), impl="torch")  # impl="torch" is CPU-only
    with pytest.raises(PlanBuildError):
        sp.from_coo(*rows, (2, 2), device="cpu", impl="cuda")


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise, with its log."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: simulated compiler failure'\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(KernelLoweringError, match="simulated compiler"):
        _build.build_all()
    assert not list((tmp_path / "build").glob("*.so"))


def _fake_nvcc(tmp_path, failing_source):
    """An nvcc stand-in that fails on ``failing_source`` and writes an empty
    library for every other source."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text(
        "#!/bin/sh\nout=''\nprev=''\nfor a in \"$@\"; do\n"
        "  [ \"$prev\" = -o ] && out=\"$a\"\n  prev=\"$a\"\ndone\n"
        f"case \"$*\" in *{failing_source}*) "
        "echo \"error: simulated failure in $*\"; exit 1;; esac\n"
        ": > \"$out\"\n")
    fake.chmod(0o755)
    return fake


def test_failed_structured_build_raises(tmp_path, monkeypatch):
    """structured_spmm.cu is built with the others, and its failure raises
    from the wrappers of both structured kernels: an operand that is not
    on the CPU never reaches the plain versions."""
    from repro_torch.kernels import structured_spmm as ss

    assert "structured_spmm" in _build.SOURCES
    _fake_nvcc(tmp_path, "structured_spmm.cu")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCS", {})

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU operand")

    monkeypatch.setattr(ss, "ref_nm_stream_spmm_dense", plain)
    monkeypatch.setattr(ss, "ref_bitmap_stream_spmm", plain)
    # tensors on the "meta" device: not on the CPU, and no card needed
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    t, bm, bk = 3, 16, 64
    steps = torch.zeros(t, **i32)
    segments = (torch.zeros(t, **i32), torch.zeros(2, **i32))
    b = torch.zeros(bk, 8, **meta)
    before = (ss.nm_tile_spmm.launches, ss.bitmap_tile_spmm.launches)
    with pytest.raises(KernelLoweringError, match="structured_spmm.cu"):
        ss.nm_tile_spmm(steps, steps, torch.zeros(t, bm, 8, **meta),
                        torch.zeros(t, bm, 4, **i32), b, num_windows=1,
                        bm=bm, bk=bk, n_pat=2, m_pat=16, segments=segments)
    with pytest.raises(KernelLoweringError, match="structured_spmm.cu"):
        ss.bitmap_tile_spmm(steps, steps, torch.zeros(t, bm, 2, **i32),
                            torch.zeros(t, bm, 8, **meta), b, num_windows=1,
                            bm=bm, bk=bk, row_cap=8, segments=segments)
    assert (ss.nm_tile_spmm.launches,
            ss.bitmap_tile_spmm.launches) == before
    # the other sources built: only the failing one is reported
    assert len(list((tmp_path / "build").glob("*.so"))) == 3


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path / "none"))
    with pytest.raises(KernelLoweringError, match="nvcc not found"):
        _build.build_all()


def test_nonzero_launch_status_raises():
    _build.check_status(0, "dense_tile_spmm")
    with pytest.raises(DispatchError, match="cudaError_t 9"):
        _build.check_status(9, "dense_tile_spmm")


@pytest.mark.parametrize("batched", [False, True])
def test_torch_impl_spmm_gradient_is_at_g(matrix, batched):
    """On impl="torch" the backward runs the plain versions on the
    transpose plan: the gradient of sum(spmm(A, B) * G) in B is A^T G
    (fp64 dense)."""
    a, _, _, _, A = matrix
    rng = np.random.RandomState(3)
    shape = (2, 110, 7) if batched else (110, 7)
    b = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    g = rng.randn(*shape[:-2], 140, 7)
    b.requires_grad_(True)
    out = sp.bspmm(A, b) if batched else sp.spmm(A, b)
    (out * torch.from_numpy(g.astype(np.float32))).sum().backward()
    want = np.einsum("mk,...mn->...kn", a.astype(np.float64), g)
    err = float(np.abs(b.grad.numpy().astype(np.float64) - want).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), err


def test_sparse_times_sparse_raises_typed_error(matrix):
    """SparseMatrix @ SparseMatrix is spspmm, which the port does not
    carry yet: a typed error that names it (not an AttributeError)."""
    from repro_torch.errors import NotPortedError

    A = matrix[-1]
    with pytest.raises(NotPortedError, match="spspmm") as err:
        A @ A
    assert isinstance(err.value, DispatchError)
    with pytest.raises(NotPortedError, match="spspmm"):
        A @ A.plan
