"""The port's RSL trainer (``python -m repro_torch.launch.train_rsl``), the
counterpart of examples/train_rsl.py, at a small width on the CPU.

The loss falls (the reference's own gate, tests/test_rsgd.py: the mean of
the last 10 steps below half the first 5's) and the train accuracy passes
0.85; the printed lines are the reference's; a rerun from the seed gives
the same bits; ``--session-dir`` resumes the gradient-spectrum Session on
a second run; and a session directory that the reference's ``Session``
wrote on the same gradient operand is resumed by the port's trainer.
Without ``--device`` the trainer runs on the card, and without one it
raises.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.api as rapi
from repro.core.operators import LowRankOp as RefLowRankOp
from repro_torch.api.session import Session
from repro_torch.core import rsgd
from repro_torch.data.synthetic import rsl_batch
from repro_torch.launch import train_rsl

SMALL = ["--device", "cpu", "--d1", "120", "--d2", "100", "--n-train",
         "1024", "--batch", "64"]


def test_trainer_learns_at_a_small_width(capsys):
    out = train_rsl.main(SMALL + ["--steps", "60"])
    losses = out["losses"]
    assert len(losses) == 60 and np.all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:5])
    assert out["train_acc"] >= 0.85
    assert out["device"] == "cpu" and out["memory"] is None
    assert len(out["spectrum"]) == 5 and min(out["spectrum"]) > 0
    assert len(out["planted"]) == 5 and out["session"] is None
    text = capsys.readouterr().out
    for line in ("[rsl] W: 120 x 100 rank 5", "[rsl] retraction: tracking",
                 "[rsl] step    0: loss", "[rsl] step   50: loss",
                 "[rsl] 60 steps in", "[rsl] learned spectrum:",
                 "[rsl] planted spectrum (top-5):"):
        assert line in text


def test_trainer_reruns_bit_for_bit_and_observes_each_step():
    events = []
    a = train_rsl.main(SMALL + ["--steps", "8", "--seed", "3"],
                       observe=events.append)
    b = train_rsl.main(SMALL + ["--steps", "8", "--seed", "3"])
    assert a["losses"] == b["losses"]
    assert all(torch.equal(x, y) for x, y in zip(a["W"], b["W"]))
    assert [e["step"] for e in events] == list(range(8))
    assert events[-1]["W"] is a["W"] and events[1]["W_prev"] is events[0]["W"]
    assert set(events[0]) == {"step", "W_prev", "batch", "W", "loss"}
    c = train_rsl.main(SMALL + ["--steps", "8", "--seed", "4"])
    assert c["losses"] != a["losses"]


def test_cold_retraction_trains_too():
    out = train_rsl.main(SMALL + ["--steps", "60", "--no-track"])
    assert np.mean(out["losses"][-10:]) < 0.5 * np.mean(out["losses"][:5])


def test_session_dir_resumes_on_a_second_run(tmp_path, capsys):
    args = SMALL + ["--steps", "51", "--grad-spectrum", "--session-dir",
                    str(tmp_path)]
    events = []
    first = train_rsl.main(args, observe=events.append)
    assert first["session"]["solves"] == 2
    assert first["session"]["resumed_at"] is None
    assert first["session"]["kinds"][0] == "cold"
    logged = [e for e in events if "grad" in e]
    assert [e["step"] for e in logged] == [0, 50]
    assert "resumed" not in capsys.readouterr().out
    second = train_rsl.main(args)
    assert second["session"]["resumed_at"] == 2
    assert second["session"]["solves"] == 4
    assert second["session"]["kinds"][:2] == first["session"]["kinds"]
    text = capsys.readouterr().out
    assert "gradient-spectrum session resumed at solve 2" in text
    assert "session state saved to" in text


def test_trainer_resumes_a_session_the_reference_wrote(tmp_path, capsys):
    """The reference's Session, solved on the port's first gradient
    operand (its factors as numpy arrays) and saved, is resumed by the
    port's trainer: the checkpoint format is shared."""
    seed, d1, d2, rank, n, batch = 0, 120, 100, 5, 1024, 64
    ds, W = train_rsl.build(seed, n, d1, d2, rank, "cpu")
    b0 = rsl_batch(ds, seed, 0, batch)
    g0 = rsgd.batch_euclidean_grad(W, b0["x"], b0["v"], b0["y"])
    ref_op = RefLowRankOp(*(np.asarray(t) for t in (g0.op.U, g0.op.s,
                                                    g0.op.Vt)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = rapi.session(ref_op, rapi.SVDSpec(method="fsvd", rank=rank),
                            key=jax.random.PRNGKey(2))
        f = sess.solve()
        sess.save(str(tmp_path))
    restored = Session.restore(str(tmp_path), g0.op, device="cpu")
    assert np.array_equal(restored.fact.s.numpy(), np.asarray(f.s))
    out = train_rsl.main(SMALL + ["--steps", "1", "--grad-spectrum",
                                  "--session-dir", str(tmp_path)])
    assert out["session"]["resumed_at"] == 1
    assert out["session"]["kinds"][0] == "cold"
    assert out["session"]["solves"] == 2
    assert "gradient-spectrum session resumed at solve 1" in \
        capsys.readouterr().out


def test_trainer_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_rsl.main(SMALL[2:] + ["--steps", "1"])
