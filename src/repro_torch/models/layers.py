"""Shared layer primitives: norms, initializers, RoPE, activations, softcap.

Counterpart of ``repro.models.layers``.  Parameters are drawn into nested
dicts of tensors with a logical-axes twin of the same structure (a tuple
of axis names per tensor dimension), under the reference's names; the
model module (``repro_torch.models.model``) turns the tree into
``nn.Parameter``s.  The functions here act on plain tensors.

Tensor parallelism over a mesh's "model" axis (Megatron's layout, what
the reference's GSPMD derives from its rules): a layer whose weights'
spec splits a dimension (heads, the MLP's width, the vocabulary) over
"model" computes the rank's block of it, as the block it is given says
(:func:`block_split`).  :func:`enter` marks where a tensor
that every rank of the "model" group holds alike enters such a block
(the identity; its gradient, partial on each rank, summed over the
group), :func:`leave` where the block's partial result leaves it (summed
over the group; its gradient passed on unchanged).  Both sums are
``distributed.matvec``'s shard-order sums over the "model" group, so
every rank of the group holds the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# parameter spec plumbing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParamBag:
    """Collects (param, logical-axes) pairs during init.

    Every draw comes from ``generator`` and every tensor lands on its
    device.  ``logical`` mirrors the params dict with tuples of logical
    axis names per dimension, e.g. ``("embed", "heads", "head_dim")``.
    """

    generator: torch.Generator
    params: dict = dataclasses.field(default_factory=dict)
    logical: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def _put(self, name, w, axes):
        self.params[name] = w
        self.logical[name] = tuple(axes)
        return w

    def dense(self, name: str, shape: Sequence[int], axes: Sequence[str],
              dtype: torch.dtype, scale: Optional[float] = None) -> Tensor:
        """Normal draws with std = ``scale``, or ``fan_in ** -0.5`` where
        none is given (fan_in = the first dimension of a matrix), drawn in
        f32 and cast to ``dtype``."""
        shape = tuple(shape)
        if scale is None:
            fan_in = shape[0] if len(shape) >= 2 else shape[-1]
            scale = fan_in ** -0.5
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return self._put(name, w.mul_(scale).to(dtype), axes)

    def uniform(self, name: str, shape: Sequence[int], axes: Sequence[str]
                ) -> Tensor:
        """f32 uniform draws on [0, 1)."""
        return self._put(name, torch.rand(tuple(shape),
                                          generator=self.generator,
                                          device=self.device), axes)

    def ones(self, name: str, shape: Sequence[int], axes: Sequence[str],
             dtype: torch.dtype) -> Tensor:
        return self._put(name, torch.ones(tuple(shape), dtype=dtype,
                                          device=self.device), axes)

    def zeros(self, name: str, shape: Sequence[int], axes: Sequence[str],
              dtype: torch.dtype) -> Tensor:
        return self._put(name, torch.zeros(tuple(shape), dtype=dtype,
                                           device=self.device), axes)

    def sub(self, name: str) -> "ParamBag":
        child = ParamBag(self.generator)
        self.params[name] = child.params
        self.logical[name] = child.logical
        return child

    def done(self) -> tuple[dict, dict]:
        return self.params, self.logical


def stacked_logical(logical: dict, axis_name: str = "layers") -> dict:
    """The logical axes of a stack of layers: ``axis_name`` in front of
    every leaf's axes (the reference's ``stack_bags``)."""
    return {k: (stacked_logical(v, axis_name) if isinstance(v, dict)
                else (axis_name,) + tuple(v))
            for k, v in logical.items()}


# ---------------------------------------------------------------------------
# tensor parallelism over "model"
# ---------------------------------------------------------------------------

def block_split(mesh, got: int, n: int, what: str
                ) -> Optional[tuple[int, int]]:
    """How a layer computes a dimension of ``n`` entries (heads, the MLP's
    width, the vocabulary) of which the weight it is given holds ``got``:
    None where it holds them all, (M, i) where it holds its block of a
    "model" axis of size M > 1 at this rank's position i.  So the layer
    follows the block its weight's spec gave it
    (``distributed.partition.model_region``); any other count is
    refused."""
    if got == n:
        return None
    from repro_torch.distributed.partition import mesh_sizes, my_coord
    M = mesh_sizes(mesh).get("model", 1) if mesh is not None else 1
    if M > 1 and got * M == n:
        return M, my_coord(mesh)["model"]
    raise ValueError(f"{what} has {got} of {n} entries: neither all of "
                     f"them nor a block of a 'model' axis of {M}")


class _Enter(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradients summed over
    "model" (one large-tensor reduction for all of them)."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        from repro_torch.distributed.matvec import psum_large
        return (None, *psum_large(gs, ctx.mesh, ("model",)))


class _Leave(torch.autograd.Function):
    """Forward: the sum over "model" (the large-tensor reduction, or a
    gather of the small tensors).  Backward: the gradients unchanged."""

    @staticmethod
    def forward(ctx, mesh, small, *xs):
        from repro_torch.distributed.matvec import psum, psum_large
        if small:
            return tuple(psum(x, mesh, "model") for x in xs)
        return tuple(psum_large(xs, mesh, ("model",)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *gs)


def enter(mesh, *xs: Tensor) -> tuple:
    """``xs`` as they enter a block computed over "model": the identity,
    with their gradients summed over the "model" group."""
    if not torch.is_grad_enabled():
        return xs
    return _Enter.apply(mesh, *xs)


def leave(mesh, *xs: Tensor, small: bool = False) -> tuple:
    """The sums over the "model" group of the partial ``xs``, the same
    bits on every rank of it; their gradients pass unchanged.  ``small``
    tensors take one gather (:func:`distributed.matvec.psum`), large ones
    the slice reduction (``psum_large``)."""
    return _Leave.apply(mesh, small, *xs)


def gather_model(x: Tensor, mesh, dim: int = -1) -> Tensor:
    """The blocks of ``x`` along ``dim`` of every rank of the "model"
    group, concatenated in shard order (no gradient)."""
    from repro_torch.distributed.matvec import _all_gather
    rows = _all_gather(x, mesh, ("model",))
    return torch.cat(list(rows.unbind(0)), dim=dim)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(bag: ParamBag, name: str, dim: int, kind: str,
              dtype: torch.dtype) -> None:
    sub = bag.sub(name)
    sub.ones("scale", (dim,), ("embed",), dtype)
    if kind == "layernorm":
        sub.zeros("bias", (dim,), ("embed",), dtype)


def apply_norm(p: dict, x: Tensor, kind: str, eps: float = 1e-6) -> Tensor:
    """RMSNorm (``x · rsqrt(mean x² + eps) · scale``) or LayerNorm, in f32
    and cast back to ``x``'s dtype."""
    dt = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        return (y * p["scale"].float()).to(dt)
    if kind == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, correction=0)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(dt)
    raise ValueError(f"unknown norm {kind!r}")


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, rotary_dim: Optional[int] = None,
               device=None) -> Tensor:
    rd = rotary_dim or head_dim
    return 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32,
                                         device=device) / rd))


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               rotary_frac: float = 1.0) -> Tensor:
    """Apply RoPE to ``x: (..., S, H, D)`` with ``positions: (..., S)``.

    Rotates the interleaved pairs ``(0::2, 1::2)`` of the first
    ``int(D · rotary_frac)`` dims (rounded down to even: StableLM's partial
    rotary); the rest passes through untouched.
    """
    d = x.shape[-1]
    rd = int(d * rotary_frac)
    rd -= rd % 2
    if rd == 0:
        return x
    xr, xp = x[..., :rd], x[..., rd:]
    inv = rope_freqs(d, theta, rd, device=x.device)          # (rd/2,)
    ang = positions[..., None].float() * inv                 # (..., S, rd/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, rd/2)
    sin = torch.sin(ang)[..., None, :]
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < d else out


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def softcap(x: Tensor, cap: Optional[float]) -> Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def activate(x: Tensor, kind: str) -> Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind in ("gelu_mlp", "gelu_exact"):
        return F.gelu(x)
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {kind!r}")


def causal_mask(q_pos: Tensor, k_pos: Tensor,
                window: Optional[int] = None) -> Tensor:
    """Boolean (..., Sq, Sk) mask: True = attend. Local window if given."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        ok &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return ok


def cross_entropy(logits: Tensor, labels: Tensor,
                  ignore_id: int = -1) -> tuple[Tensor, Tensor]:
    """Mean token cross-entropy in f32. Returns (loss, n_valid)."""
    nll, n = ce_sums(logits, labels, ignore_id)
    return nll / n.clamp(min=1), n


def ce_sums(logits: Tensor, labels: Tensor, ignore_id: int = -1
            ) -> tuple[Tensor, Tensor]:
    """Summed token NLL and the count of valid tokens, in f32."""
    logits = logits.float()
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum(), valid.sum()


def repeat_interleave(x: Tensor, n: int, dim: int) -> Tensor:
    """``x`` with every entry along ``dim`` repeated ``n`` times in place
    (``jnp.repeat``), as a view expanded and copied once; no host sync."""
    dim = dim % x.dim()
    if n == 1:
        return x
    shape = list(x.shape)
    out = x.unsqueeze(dim + 1).expand(*shape[:dim + 1], n, *shape[dim + 1:])
    return out.reshape(*shape[:dim], shape[dim] * n, *shape[dim + 1:])


def proj(x: Tensor, w: Tensor) -> Tensor:
    """``x (..., d) · w (d, *out)`` as one matrix product: the reference's
    ``einsum("bsd,d...->bs...")`` projections."""
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def proj_heads(x: Tensor, w: Tensor) -> Tensor:
    """``x (..., h, k) · w (h, k, d)`` as one matrix product: the output
    projections' ``einsum("bshk,hkd->bsd")``."""
    h, k, d = w.shape
    return (x.reshape(-1, h * k) @ w.reshape(h * k, d)).reshape(
        *x.shape[:-2], d)
