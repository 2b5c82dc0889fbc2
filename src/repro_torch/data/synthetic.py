"""Synthetic data: LM token batches, the paper's RSL similarity pairs, and
matrix-free problem generators (sparse and Kronecker operands with a dense
oracle).  Counterpart of ``repro.data.synthetic`` (``LMBatchSpec``,
``spec_for``, ``lm_batch``, ``host_slice``, ``RSLDataset``,
``make_rsl_dataset``, ``rsl_batch``, ``MatrixFreeProblem``,
``make_sparse_problem``, ``make_kron_problem``).

Each maker takes an explicit ``torch.Generator`` and draws on its device;
``lm_batch`` and ``rsl_batch`` are pure functions of (seed, step), as the
reference promises.  The two packages draw different numbers from one
seed: parity tests build the data on the reference side and hand them
over (``bridge.rsl_dataset``, ``bridge.problem``, the LM batch as numpy
arrays).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core._keys import fold_in, normal

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

class LMBatchSpec(NamedTuple):
    batch: int
    seq_len: int
    vocab: int
    num_image_tokens: int = 0     # vlm stub
    num_frames: int = 0           # audio stub
    d_model: int = 0


def spec_for(cfg: ModelConfig, shape: ShapeConfig,
             batch_override: Optional[int] = None) -> LMBatchSpec:
    B = batch_override or shape.global_batch
    S = shape.seq_len
    img = audio = 0
    if cfg.family == "vlm":
        img = cfg.vlm.num_image_tokens
        S = S - img                       # text tokens fill the remainder
    if cfg.family == "audio":
        audio = shape.seq_len
    return LMBatchSpec(B, S, cfg.vocab_size, img, audio, cfg.d_model)


def lm_batch(spec: LMBatchSpec, seed: int, step: int, device=None) -> dict:
    """One deterministic LM training batch, drawn on ``device`` (default:
    the card) from a generator derived from (``seed``, ``step``).

    Tokens follow a repeating 8-gram per row with 5 % of them replaced by
    uniform noise (so tiny models can learn structure, unlike iid-uniform
    tokens); labels are the tokens shifted by one.  VLM and audio specs
    add stub patch / frame embeddings (normal, std 0.02).
    """
    dev = resolve_device(device)
    g = fold_in(seed, step, device=dev)
    base = torch.randint(0, spec.vocab, (spec.batch, 8), generator=g,
                         device=dev, dtype=torch.int32)
    reps = -(-(spec.seq_len + 1) // 8)
    stream = base.repeat(1, reps)[:, :spec.seq_len + 1]
    noise = torch.randint(0, spec.vocab, stream.shape, generator=g,
                          device=dev, dtype=torch.int32)
    flip = torch.rand(stream.shape, generator=g, device=dev) < 0.05
    stream = torch.where(flip, noise, stream)
    batch = {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
    if spec.num_image_tokens:
        batch["img_embeds"] = normal(
            g, (spec.batch, spec.num_image_tokens, spec.d_model)) * 0.02
    if spec.num_frames:
        batch["frames"] = normal(
            g, (spec.batch, spec.num_frames, spec.d_model)) * 0.02
    return batch


def host_slice(batch: dict, host_id: int, num_hosts: int) -> dict:
    """Per-host shard of a global batch (multi-host input pipeline)."""
    def f(x):
        per = x.shape[0] // num_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: f(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# RSL pairs (the paper's application, §6.3)
# ---------------------------------------------------------------------------

class RSLDataset(NamedTuple):
    X: Tensor         # (N, d1) domain-1 samples (MNIST-like)
    V: Tensor         # (N, d2) domain-2 samples (USPS-like)
    y: Tensor         # (N,) ±1 similarity labels
    Wu: Tensor        # planted metric factors: W* = Wu @ Wv (never dense)
    Wv: Tensor

    @property
    def W_true(self) -> Tensor:
        """Dense planted metric — small-dim diagnostics only."""
        return self.Wu @ self.Wv

    def true_spectrum(self) -> Tensor:
        """Singular values of W* from its factors (no dense SVD)."""
        Ru = torch.linalg.qr(self.Wu)[1]
        Rv = torch.linalg.qr(self.Wv.T)[1]
        return torch.linalg.svdvals(Ru @ Rv.T)


def make_rsl_dataset(generator: torch.Generator, n: int, d1: int, d2: int,
                     rank: int, noise: float = 0.1) -> RSLDataset:
    """Plant a rank-``rank`` metric W* = Wu Wv; label pairs by
    sign(xᵀW*v + noise).  Mimics the paper's MNIST-vs-USPS setup (two
    domains of different dimension, similarity decided by a low-rank
    bilinear form).  Scores go through the factors, so the 1e8-entry
    metric of the end-to-end driver is never materialized.  Everything is
    drawn on the generator's device; X and V are scaled in place, so no
    second copy of either is made.
    """
    g = generator
    X = normal(g, (n, d1)).div_(d1 ** 0.25)
    V = normal(g, (n, d2)).div_(d2 ** 0.25)
    scale = (d1 * d2) ** -0.25
    Wu = normal(g, (d1, rank)) * scale
    Wv = normal(g, (rank, d2))
    score = torch.einsum("nr,nr->n", X @ Wu, V @ Wv.T)
    # jnp.std is the population std
    score = score + noise * torch.std(score, correction=0) * normal(g, (n,))
    return RSLDataset(X, V, torch.sign(score), Wu, Wv)


def rsl_batch(ds: RSLDataset, seed: int, step: int, batch: int) -> dict:
    """One training batch, a pure function of (``seed``, ``step``): the
    indices are drawn on the dataset's device from a generator derived
    from both."""
    g = fold_in(seed, step, device=ds.X.device)
    idx = torch.randint(0, ds.X.shape[0], (batch,), generator=g,
                        device=ds.X.device)
    return {"x": ds.X[idx], "v": ds.V[idx], "y": ds.y[idx]}


# ---------------------------------------------------------------------------
# Matrix-free problem generators
# ---------------------------------------------------------------------------


class MatrixFreeProblem(NamedTuple):
    op: object            # a core.operators Operator: the solver input
    dense: Tensor         # materialized reference (small dims / oracles)


def _bernoulli(gen: torch.Generator, p: float, shape) -> Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < p


def make_sparse_problem(generator: torch.Generator, m: int, n: int, *,
                        density: float = 0.02, rank: Optional[int] = None,
                        backend: str = "xla") -> MatrixFreeProblem:
    """Random sparse operand with a dense oracle.

    ``rank=None``: iid Gaussian values on a Bernoulli(density) mask
    (full-rank with probability 1).  ``rank=r``: the product of two
    sparse factors ``S₁ (m, r) @ S₂ (r, n)`` of density √density each —
    rank at most r and still sparse for a small density.
    """
    from repro_torch.core.operators import SparseOp
    g = generator
    if rank is None:
        mask = _bernoulli(g, density, (m, n))
        dense = torch.where(mask, normal(g, (m, n)), 0.0)
    else:
        d = density ** 0.5
        S1 = torch.where(_bernoulli(g, d, (m, rank)),
                         normal(g, (m, rank)), 0.0)
        S2 = torch.where(_bernoulli(g, d, (rank, n)),
                         normal(g, (rank, n)), 0.0)
        dense = S1 @ S2
    return MatrixFreeProblem(SparseOp.fromdense(dense, backend=backend),
                             dense)


def make_kron_problem(generator: torch.Generator, ma: int, na: int, mb: int,
                      nb: int) -> MatrixFreeProblem:
    """Kronecker operand ``A ⊗ B`` with its dense oracle.  The product's
    singular values are the outer product of the factors' spectra."""
    from repro_torch.core.operators import DenseOp, KroneckerOp
    A = normal(generator, (ma, na)) / (ma * na) ** 0.25
    B = normal(generator, (mb, nb)) / (mb * nb) ** 0.25
    return MatrixFreeProblem(KroneckerOp(DenseOp(A), DenseOp(B)),
                             torch.kron(A, B))
