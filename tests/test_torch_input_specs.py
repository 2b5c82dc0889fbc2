"""The port's input-spec assembly (``repro_torch.launch.input_specs``): the
cases of tests/test_input_specs.py, and every cell's structs and specs
against the reference's ``cell_inputs``.

Structs are ``meta`` tensors (no storage); specs plain tuples.  Every
applicable (arch x shape) cell is built on a (2, 4) ("data", "model")
mesh given as sizes and held leaf for leaf against the reference's on a
``jax.sharding.AbstractMesh`` of the same shape: the same leaf paths,
shapes and dtypes, and the same specs (trailing Nones dropped, as the
port writes them).
"""
import functools

import jax
import pytest
import torch

from repro.compat import abstract_mesh
from repro.configs import get_arch as ref_get_arch
from repro.configs import get_shape as ref_get_shape
from repro.configs.base import OptimConfig as RefOptimConfig
from repro.launch import input_specs as RI
from repro_torch.checkpoint.store import _children
from repro_torch.configs import (ARCHS, SHAPES, cell_applicable, get_arch,
                                 get_shape)
from repro_torch.configs.base import OptimConfig
from repro_torch.launch import input_specs as TI

CELLS = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)
         if cell_applicable(a, s)[0]]
MESH = {"data": 1, "model": 1}


def _is_spec(x) -> bool:
    return type(x) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(a, str) for a in e))
        for e in x)


def _port_leaves(tree, specs=False, path=""):
    """{path: leaf} in the reference's key names (dict keys, NamedTuple
    fields, sequence indices); a spec tuple is a leaf when ``specs``."""
    if tree is None:
        return {}
    if specs and _is_spec(tree):
        return {path: tree}
    kids = _children(tree)
    if kids is None:
        return {path: tree}
    out = {}
    for k, x in kids:
        out.update(_port_leaves(x, specs, f"{path}/{k}" if path else k))
    return out


def _ref_leaves(tree) -> dict:
    from repro.checkpoint.store import _key_name
    return {"/".join(_key_name(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _norm(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_inputs_build(arch, shape):
    cell = TI.cell_inputs(get_arch(arch), get_shape(shape), OptimConfig(),
                          MESH)
    structs = _port_leaves(cell["args_struct"])
    shards = _port_leaves(cell["in_shardings"], specs=True)
    # struct and specs share the tree structure
    assert sorted(structs) == sorted(shards)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "meta"
               for x in structs.values())
    assert all(_is_spec(s) for s in shards.values())


def test_abstract_init_no_allocation():
    cfg = get_arch("deepseek-v2-236b")      # 236B params: must NOT allocate
    struct, logical = TI.abstract_init(cfg)
    leaves = _port_leaves(struct)
    assert all(x.device.type == "meta" for x in leaves.values())
    assert sum(x.numel() for x in leaves.values()) > 200e9


def test_applicability_matrix():
    """40 cells total: 32 lowered + 8 documented skips."""
    total = len(ARCHS) * len(SHAPES)
    skips = [(a, s) for a in ARCHS for s in SHAPES
             if not cell_applicable(a, s)[0]]
    assert total == 40
    assert len(skips) == 8
    assert all(s == "long_500k" for _, s in skips)
    assert {"mamba2-780m", "zamba2-1.2b"}.isdisjoint({a for a, _ in skips})


def test_decode_cache_long500k_seq_sharded():
    """B = 1 long-context cells shard the cache sequence axis over
    "data"; no process group or device is needed."""
    struct, shard = TI.cache_struct_and_shardings(
        get_arch("zamba2-1.2b"), get_shape("long_500k"),
        {"data": 2, "model": 1})
    assert "data" in shard["attn"]["k"]
    assert struct["attn"]["k"].device.type == "meta"


def test_train_batch_vlm_audio_extras():
    b_vlm = TI.train_batch_struct(get_arch("llava-next-34b"),
                                  get_shape("train_4k"))
    assert "img_embeds" in b_vlm
    assert b_vlm["tokens"].shape[1] + b_vlm["img_embeds"].shape[1] == 4096
    b_aud = TI.train_batch_struct(get_arch("whisper-base"),
                                  get_shape("train_4k"))
    assert "frames" in b_aud


@functools.lru_cache(maxsize=None)
def _ref_cell(arch, shape):
    return RI.cell_inputs(ref_get_arch(arch), ref_get_shape(shape),
                          RefOptimConfig(), abstract_mesh((2, 4),
                                                          ("data", "model")))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_inputs_match_reference(arch, shape):
    ref = _ref_cell(arch, shape)
    port = TI.cell_inputs(get_arch(arch), get_shape(shape), OptimConfig(),
                          {"data": 2, "model": 4})
    assert port["kind"] == ref["kind"]
    want, got = _ref_leaves(ref["args_struct"]), \
        _port_leaves(port["args_struct"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
    want = {k: _norm(s.spec) for k, s in
            _ref_leaves(ref["in_shardings"]).items()}
    got = _port_leaves(port["in_shardings"], specs=True)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k] == w, (k, got[k], w)
