"""The port's CUDA kernels on the card, against their plain-torch versions.

Every test here is marked ``gpu`` and skips without a CUDA card.  This
file imports torch, numpy and repro_torch only (the card's machine has no
JAX), so on the card it runs without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: rtol 1e-5 with atol 1e-5·max|plain| when A and the basis are
f32 (the kernel and the plain version differ only in summation order),
3e-2 where either is stored bf16 (tests/test_kernels.py:151-187).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import SVDSpec, estimate_rank, factorize
from repro_torch.core.operators import DenseOp
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import ops
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest --noconftest "
                    "-m gpu tests/test_torch_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, n, k, adt, qdt, seed):
    rng = np.random.default_rng(seed)

    def t(x, dt=torch.float32):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dt).cuda()

    A = t(rng.standard_normal((m, n)), adt)
    p, yn = t(rng.standard_normal(n)), t(rng.standard_normal(n))
    q, ym = t(rng.standard_normal(m)), t(rng.standard_normal(m))
    Q = t(np.linalg.qr(rng.standard_normal((m, k)))[0], qdt)
    P = t(np.linalg.qr(rng.standard_normal((n, k)))[0], qdt)
    return A, p, q, ym, yn, Q, P


def _assert_close(got, want, rtol):
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("m,n,k", [(64, 48, 4), (300, 517, 17),
                                   (127, 383, 9), (1024, 512, 64),
                                   (4099, 2050, 201)])
@pytest.mark.parametrize("adt,qdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16)])
def test_kernels_match_plain_versions(cuda, m, n, k, adt, qdt):
    A, p, q, ym, yn, Q, P = _inputs(m, n, k, adt, qdt, m + n + k)
    rtol = 1e-5 if adt == qdt == torch.float32 else 3e-2
    c = torch.linspace(-1, 1, k, device=cuda)
    alpha = torch.tensor([0.37], device=cuda)
    before = dict(gs.LAUNCHES)
    cases = [(lambda: gs.mv_qtv(A, p, ym, alpha, Q),
              ref.mv_qtv(A, p, ym, alpha, Q)),
             (lambda: gs.rmv_qtv(A, q, yn, 1.7, P),
              ref.rmv_qtv(A, q, yn, 1.7, P)),
             (lambda: gs.proj_qtv(ym, Q, c), ref.proj_qtv(ym, Q, c)),
             (lambda: gs.proj_norm(ym, Q, c), ref.proj_norm(ym, Q, c))]
    for kern, want in cases:
        got = kern()
        _assert_close(got, want, rtol)
        for a, b in zip(got, kern()):      # deterministic cross-block sums
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert all(gs.LAUNCHES[name] == before[name] + 2 for name in before)


@pytest.mark.parametrize("passes", [0, 1, 2, 3])
def test_fused_steps_match_plain_versions(cuda, passes):
    A, p, q, ym, yn, Q, P = _inputs(300, 517, 17, torch.float32,
                                    torch.float32, passes)
    _assert_close(ops.gk_step_fused(A, p, ym, 0.37, Q, passes),
                  ref.gk_step(A, p, ym, 0.37, Q, passes), 1e-5)
    _assert_close(ops.gk_rstep_fused(A, q, yn, 1.7, P, passes),
                  ref.gk_rstep(A, q, yn, 1.7, P, passes), 1e-5)


def test_f64_pallas_operand_raises(cuda):
    op = DenseOp(torch.randn(40, 30, dtype=torch.float64, device=cuda),
                 backend="pallas")
    q = torch.randn(40, dtype=torch.float64, device=cuda)
    p = torch.randn(30, dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="gk_matvec"):
        op.lanczos_step(p, q, 0.5, torch.zeros(40, 3, dtype=torch.float64,
                                               device=cuda))
    with pytest.raises(NotImplementedError, match="gk_matvec"):
        op.lanczos_rstep(q, p, 0.5, torch.zeros(30, 3, dtype=torch.float64,
                                                device=cuda))


def test_wrappers_reject_strided_input(cuda):
    A, p, q, ym, yn, Q, P = _inputs(64, 48, 4, torch.float32,
                                    torch.float32, 1)
    with pytest.raises(ValueError, match="contiguous"):
        gs.mv_qtv(A.T.contiguous().T, p, ym, 0.1, Q)


def test_solvers_run_through_the_kernels(cuda):
    """factorize / estimate_rank with backend="pallas" on a card tensor
    launch the kernels and agree with the plain-torch backend."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy((rng.standard_normal((600, 12))
                          @ rng.standard_normal((12, 400))
                          ).astype(np.float32)).to(cuda)
    q1 = torch.from_numpy(2 + rng.standard_normal(600).astype(
        np.float32)).to(cuda)
    gs.reset_launches()
    got = factorize(A, SVDSpec(method="fsvd", rank=5, max_iters=30,
                               backend="pallas"), q1=q1)
    assert gs.LAUNCHES["mv_qtv"] == 30 and gs.LAUNCHES["rmv_qtv"] == 29
    want = factorize(A, SVDSpec(method="fsvd", rank=5, max_iters=30,
                                backend="xla"), q1=q1)
    torch.testing.assert_close(got.s, want.s, rtol=1e-4, atol=0.0)
    assert int(got.iterations) == int(want.iterations)
    est = estimate_rank(A, SVDSpec(max_iters=40, backend="pallas"),
                        generator=torch.Generator(device=cuda).manual_seed(0))
    assert int(est) == 12
