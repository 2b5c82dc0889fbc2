"""Solve-server CLI: synthetic traffic through ``repro_torch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.solve_serve --requests 200 \\
        --rank 8 --tenants 4 --max-batch 8 --window-ms 4 [--device cpu]

Counterpart of ``repro.launch.solve_serve``, with its flags and defaults,
plus ``--device`` (default: the CUDA card; ``cpu`` runs the plain path)
and ``--seed``, which seeds the traffic and the server's generator.
Drives a Zipf-distributed shape mix (``repro_torch.serve.traffic``) into a
:class:`~repro_torch.serve.server.SolveServer` from a pool of client
threads and prints, as JSON, the clients' tally (``"traffic"``) beside
the server's stats endpoint (``"server"``) — requests/sec, p50/p99
latency, bucket hit rate, batch histogram, tenant-session counters, the
process-wide plan-cache counters and the health block.
``--stats-every N`` streams interim snapshots (one JSON line each) while
traffic runs.

``--deadline-ms`` attaches a per-request deadline (expired requests are
dropped at dispatch admission); ``--chaos`` runs the whole replay under
fault injection (``repro_torch.runtime.faults.chaos``: dispatch
crashes/hangs + transient solver faults) — the reliability claim is that
the replay still drains with every request terminating in a result, a
labeled degraded result, or a typed error.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import threading
import time

import torch

from repro_torch.api.spec import SVDSpec
from repro_torch.runtime import faults
from repro_torch.serve import QueueFull, SolveServer, WorkerCrashed
from repro_torch.serve.traffic import DEFAULT_SHAPES, synthetic_stream


def run_traffic(server: SolveServer, requests, *, clients: int = 4,
                timeout: float = 120.0, deadline_ms=None,
                max_attempts: int = 3, on_result=None) -> dict:
    """Replay ``requests`` through ``server`` from ``clients`` threads.

    Returns ``{"ok", "degraded", "rejected", "failed", "timeouts",
    "errors", "wall_s"}``.  Rejected submissions (backpressure) and
    :class:`~repro_torch.serve.resilience.WorkerCrashed` failures — typed
    "safe to retry" — retry with a short backoff up to ``max_attempts``;
    other failures are terminal and tallied by exception type under
    ``"errors"``.  Result waits use ``cancel_on_timeout=True`` so an
    abandoned request releases its ``max_queue`` slot.  ``on_result(req,
    outcome, detail)`` (called under the tally lock) lets callers collect
    per-request results.

    A tenant's requests are first submitted in stream order: a client
    holding a tenant's later request waits until the clients holding its
    earlier ones have submitted them, so a drift never reaches the
    server before the request it follows (the reference's clients race
    there, and a ``delta`` that overtakes its tenant's first
    ``factorize`` fails).  A retry after ``WorkerCrashed`` resubmits
    without waiting.
    """
    requests = list(requests)
    counts = {"ok": 0, "degraded": 0, "rejected": 0, "failed": 0,
              "timeouts": 0}
    errors: dict = {}
    lock = threading.Lock()
    it = iter(enumerate(requests))
    # each tenant request's place in its tenant's stream, and how many of
    # the tenant's requests have been submitted so far
    turn, seen = {}, {}
    for i, req in enumerate(requests):
        if req.tenant is not None:
            turn[i] = seen.get(req.tenant, 0)
            seen[req.tenant] = turn[i] + 1
    submitted = dict.fromkeys(seen, 0)
    order = threading.Condition()

    def one(operand, kind, tenant, place):
        attempt = 0
        while True:
            attempt += 1
            if attempt == 1 and place is not None:
                with order:
                    order.wait_for(lambda: submitted[tenant] == place)
            try:
                ticket = server.submit(operand, kind=kind, tenant=tenant,
                                       deadline_ms=deadline_ms)
            except QueueFull:
                if attempt < max_attempts:
                    time.sleep(0.05)
                    continue
                return "rejected", None
            except Exception as exc:    # noqa: BLE001 — e.g. quarantine
                return "failed", exc
            finally:
                if attempt == 1 and place is not None:
                    with order:
                        submitted[tenant] += 1
                        order.notify_all()
            try:
                res = ticket.result(timeout, cancel_on_timeout=True)
                return "ok", res
            except TimeoutError:
                # cancel_on_timeout released the slot; the request is gone
                return "timeouts", None
            except WorkerCrashed as exc:
                if attempt < max_attempts:
                    time.sleep(0.02)
                    continue
                return "failed", exc
            except Exception as exc:    # noqa: BLE001 — typed, terminal
                return "failed", exc

    def worker():
        while True:
            with lock:
                i, req = next(it, (None, None))
            if req is None:
                return
            if req.kind == "delta":
                # structured tenant drift: ship only the low-rank factors
                operand, kind = req.delta, "delta"
            elif req.kind == "entries":
                # unstructured tenant drift: ship only the COO triplets
                operand, kind = req.entries, "entries"
            elif req.tenant is not None:
                operand, kind = req.A, "factorize"
            else:
                operand, kind = req.A, req.kind
            outcome, detail = one(operand, kind, req.tenant, turn.get(i))
            with lock:
                counts[outcome] += 1
                if outcome == "ok" and getattr(detail, "meta", None) \
                        and detail.meta.get("degraded"):
                    counts["degraded"] += 1
                if outcome == "failed":
                    name = type(detail).__name__
                    errors[name] = errors.get(name, 0) + 1
                if on_result is not None:
                    on_result(req, outcome, detail)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    counts["wall_s"] = time.perf_counter() - t0
    counts["errors"] = errors
    return counts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent client threads")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--method", default="fsvd")
    ap.add_argument("--zipf-a", type=float, default=1.1)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--tenant-fraction", type=float, default=0.25)
    ap.add_argument("--estimate-fraction", type=float, default=0.0)
    ap.add_argument("--structured-drift", action="store_true",
                    help="tenant drifts are rank-k deltas shipped as "
                         "kind='delta' requests (the serving stack's "
                         "zero-iteration update path)")
    ap.add_argument("--drift-rank", type=int, default=2,
                    help="rank of each structured tenant drift")
    ap.add_argument("--quantum", type=int, default=32)
    ap.add_argument("--mode", choices=("exact", "shared"), default="exact")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=4.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="evicted tenant sessions checkpoint here")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; expired requests are "
                         "dropped at dispatch admission with "
                         "DeadlineExceeded")
    ap.add_argument("--chaos", action="store_true",
                    help="replay under fault injection: dispatch "
                         "crashes/hangs + transient solver faults "
                         "(repro_torch.runtime.faults.chaos)")
    ap.add_argument("--chaos-crash-p", type=float, default=0.03,
                    help="per-dispatch worker-crash probability under "
                         "--chaos")
    ap.add_argument("--chaos-hang-p", type=float, default=0.01,
                    help="per-dispatch hang probability under --chaos")
    ap.add_argument("--chaos-transient-p", type=float, default=0.05,
                    help="per-solve transient-fault probability under "
                         "--chaos")
    ap.add_argument("--hang-timeout-s", type=float, default=30.0,
                    help="watchdog restarts the dispatch worker when one "
                         "dispatch overruns this")
    ap.add_argument("--degraded-method", default="gnystrom",
                    help="in-graph solver backing the breaker's shed "
                         "plan (reported in meta['method'])")
    ap.add_argument("--stats-every", type=float, default=0.0,
                    help="stream interim stats JSON every N seconds")
    ap.add_argument("--stats-json", default=None,
                    help="write the final stats snapshot to this file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the traffic and the server's generator")
    ap.add_argument("--device", default=None,
                    help="the server's device (default: the CUDA card; "
                         "'cpu' runs the plain path)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip deploy-time staging of the traffic shape "
                         "menu (first-of-a-signature batches then build "
                         "inside the serving path)")
    args = ap.parse_args(argv)

    spec = SVDSpec(method=args.method, rank=args.rank)
    server = SolveServer(spec, quantum=args.quantum, mode=args.mode,
                         max_batch=args.max_batch,
                         window_ms=args.window_ms,
                         max_queue=args.max_queue,
                         checkpoint_dir=args.checkpoint_dir,
                         deadline_ms=args.deadline_ms,
                         hang_timeout_s=args.hang_timeout_s,
                         degraded_method=args.degraded_method,
                         generator=torch.Generator().manual_seed(args.seed),
                         device=args.device)
    stream = synthetic_stream(
        args.requests, zipf_a=args.zipf_a, rank=args.rank,
        tenants=args.tenants, tenant_fraction=args.tenant_fraction,
        estimate_fraction=args.estimate_fraction,
        structured_drift=args.structured_drift,
        drift_rank=args.drift_rank, seed=args.seed)
    if not args.no_warmup:
        t0 = time.perf_counter()
        staged = server.warmup(DEFAULT_SHAPES,
                               estimates=args.estimate_fraction > 0)
        print(json.dumps({"warmup": {
            "signatures": staged,
            "wall_s": time.perf_counter() - t0}}), flush=True)

    stop_poll = threading.Event()
    if args.stats_every > 0:
        def poll():
            while not stop_poll.wait(args.stats_every):
                print(json.dumps({"interim": server.stats()}), flush=True)
        threading.Thread(target=poll, daemon=True).start()

    chaos_ctx = faults.chaos(
        args.seed, dispatch_crash_p=args.chaos_crash_p,
        dispatch_hang_p=args.chaos_hang_p,
        solve_transient_p=args.chaos_transient_p) \
        if args.chaos else contextlib.nullcontext()
    with server, chaos_ctx:
        counts = run_traffic(server, stream, clients=args.clients,
                             deadline_ms=args.deadline_ms)
        faults.disarm_all()   # serve the drain (close) fault-free
        stop_poll.set()
        stats = server.stats()

    out = {"traffic": counts, "server": stats}
    print(json.dumps(out, indent=2, sort_keys=True))
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(out, fh, indent=2, sort_keys=True)
    return out


if __name__ == "__main__":
    main()
