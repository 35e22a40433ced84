"""The port's CNN serving (``repro_torch.launch.serve_cnn``) and its
resilience layer (``repro_torch.runtime``) against the JAX package.

* One request stream, with deadlines, an admission bound, a poison
  request and a transient fault every 3rd call, through the port's and the
  reference's ``MicroBatchQueue`` (fake clocks) over LeNet-5 at width 0.25,
  converted by the reference and carried across: every ticket resolves
  the same way with ``np.array_equal`` logits and equal latency, and the
  resilience and plan-cache counters are equal.
* The drills of ``tests/test_resilience.py`` on the port (``chaos``
  marker): quarantine in O(log n) flushes with healthy tickets equal to
  the oracle, retries reconciled with injected faults, deadlines, the
  admission bound, the health machine.
* The CLI: argument errors exit 2, ``--auto`` and ``--data-parallel`` > 1
  raise ``NotImplementedError``, and a CPU run serves every request.

Every comparison is exact; latencies are fake-clock times.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conversion as jconv
from repro.launch import serve_cnn as jserve
from repro.models import lenet as jlenet
from repro.runtime import resilience as jrz
from repro_torch import api, carry
from repro_torch.core import engine
from repro_torch.launch import serve_cnn
from repro_torch.runtime import resilience as rz
from repro_torch.runtime.restart import FaultInjected
from repro_torch.runtime.straggler import StragglerMonitor

RNG = np.random.default_rng(11)
BUCKETS = (1, 4, 8, 32)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _noop(_dt):
    return None


@pytest.fixture(scope="module")
def nets():
    """LeNet-5 (width 0.25, "or" pool, T = 4) converted by the reference
    and carried across."""
    import jax

    static, params, hw = jlenet.make(jax.random.PRNGKey(0), pool_mode="or",
                                     width_mult=0.25)
    calib = RNG.uniform(0, 1, (4,) + hw).astype(np.float32)
    jnet = jconv.convert(static, params, jnp.asarray(calib), num_steps=4)
    tnet = carry.qnet_from_numpy(
        jnet.static,
        [None if qp is None else {k: None if qp[k] is None
                                  else np.asarray(qp[k])
                                  for k in ("w_q", "b_int", "mult")}
         for qp in jnet.qlayers],
        num_steps=4, weight_bits=jnet.weight_bits,
        input_scale=jnet.input_scale, logit_scale=jnet.logit_scale,
        encoding=jnet.spec)
    return jnet, tnet, hw


@pytest.fixture(scope="module")
def server(nets):
    _, tnet, hw = nets
    srv = serve_cnn.CNNServer(tnet, hw, buckets=BUCKETS, device="cpu")
    srv.warmup()
    return srv


def _req(server, n=1):
    return RNG.uniform(0, 1, (n,) + server.item_shape).astype(np.float32)


def _queue(server, clock, **kw):
    kw.setdefault("timeout_s", 1e9)
    kw.setdefault("max_batch", 32)
    return serve_cnn.MicroBatchQueue(server, clock=clock,
                                     sleep=clock.advance, **kw)


# ---------------------------------------------------------------------------
# The same stream through both packages' queues.
# ---------------------------------------------------------------------------

COUNTERS = ("hits", "compiles", "executions", "padded_rows", "failures",
            "rejected", "shed", "retried", "quarantined", "degraded_flushes")


def _drive(pkg_serve, pkg_rz, server, reqs):
    """One stream: a transient fault every 3rd infer, NaN poison,
    max_batch 8, admission bound 12, deadlines on every 4th request, the
    clock advancing 1 ms between submits."""
    plan = pkg_rz.FaultPlan(fail_every=3, poison_nan=True)
    chaos = pkg_rz.ChaosServer(server, plan, delay=_noop)
    clock = FakeClock()
    q = pkg_serve.MicroBatchQueue(
        chaos, clock=clock, sleep=clock.advance, max_batch=8,
        timeout_s=0.0035, max_pending=12,
        retry=pkg_rz.RetryPolicy(max_retries=2, backoff_s=0.001))
    tickets = []
    for i, r in enumerate(reqs):
        tickets.append(q.submit(r, deadline_s=0.002 if i % 4 == 3 else None))
        clock.advance(0.001)
    q.flush()
    return q, plan, tickets


@pytest.mark.parametrize("backend", ["kernels", "jnp"])
def test_stream_matches_reference_queue(nets, backend):
    jnet, tnet, hw = nets
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 5, 24)
    reqs = [rng.uniform(0, 1, (int(n),) + hw).astype(np.float32)
            for n in sizes]
    reqs[9][:] = np.nan
    jsrv = jserve.CNNServer(jnet, hw, buckets=BUCKETS, backend="jnp")
    tsrv = serve_cnn.CNNServer(tnet, hw, buckets=BUCKETS, backend=backend,
                               device="cpu")
    jsrv.warmup()
    tsrv.warmup()
    jq, jplan, jt = _drive(jserve, jrz, jsrv, reqs)
    tq, tplan, tt = _drive(serve_cnn, rz, tsrv, reqs)
    assert all(t.done for t in tt)
    kinds = {type(t.error).__name__ for t in tt}
    assert {"NoneType", "RequestPoisoned", "DeadlineExceeded"} <= kinds
    for a, b in zip(tt, jt):
        assert (a.ok, type(a.error).__name__) == (b.ok,
                                                  type(b.error).__name__)
        assert a.latency_s == b.latency_s and a.size == b.size
        if b.ok:
            np.testing.assert_array_equal(a.result.numpy(),
                                          np.asarray(b.result))
    ts, js = tsrv.stats(), jsrv.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert (tq.flushes, tq.health.state, tq.pending_images) == (
        jq.flushes, jq.health.state, jq.pending_images)
    assert (tplan.calls, tplan.injected) == (jplan.calls, jplan.injected)
    assert ts["quarantined"] == 1 and ts["retried"] > 0


def test_resilience_policies_match_reference():
    """The health machine and the fault plan step the same way."""
    assert rz.RetryPolicy(3, 0.01, 2.0).backoff(2) == \
        jrz.RetryPolicy(3, 0.01, 2.0).backoff(2)
    lat = [0.01, 0.011, 0.009, 0.5, 0.01, 0.01, 0.9, 0.8, 0.7, 0.6, 0.01]
    states = []
    for mod, smon in ((rz, StragglerMonitor), (jrz, jrz.StragglerMonitor)):
        mon = mod.HealthMonitor(smon(window=8, threshold=3.0, warmup=1),
                                drain_after=3, recover_after=2)
        states.append([mon.record_flush(d) for d in lat]
                      + [mon.record_failure()])
    assert states[0] == states[1]
    x = np.zeros((3, 2, 2, 1), np.float32)
    outs = []
    for mod in (rz, jrz):
        plan = mod.FaultPlan(fail_every=4, latency_every=3,
                             shard_loss_after=5, shard_rows=2)
        out = []
        for _ in range(9):
            try:
                plan.apply(x, _noop)
                out.append("ok")
            except RuntimeError as err:
                out.append(str(err))
        outs.append((out, plan.injected))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Policy objects.
# ---------------------------------------------------------------------------


def test_retry_policy_backoff_and_validation():
    p = rz.RetryPolicy(max_retries=3, backoff_s=0.01, backoff_mult=2.0)
    assert [p.backoff(a) for a in range(3)] == pytest.approx(
        [0.01, 0.02, 0.04])
    with pytest.raises(ValueError, match="max_retries"):
        rz.RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="backoff"):
        rz.RetryPolicy(backoff_mult=0.5)


def test_error_taxonomy_is_serve_error():
    for cls in (rz.AdmissionError, rz.DeadlineExceeded, rz.RequestPoisoned):
        assert issubclass(cls, rz.ServeError)
        assert issubclass(cls, RuntimeError)


def test_health_monitor_state_machine():
    mon = rz.HealthMonitor(StragglerMonitor(threshold=3.0, warmup=0),
                           drain_after=2, recover_after=2)
    assert mon.state == rz.HEALTHY and mon.accepting
    for _ in range(4):
        mon.record_flush(0.01)
    assert mon.record_flush(1.0) == rz.DEGRADED
    assert mon.degraded and mon.accepting
    mon.record_flush(0.01)
    assert mon.record_flush(0.01) == rz.HEALTHY
    mon.record_flush(1.0)
    assert mon.record_failure() == rz.DRAINING
    assert not mon.accepting
    mon.resume()
    assert mon.state == rz.HEALTHY and mon.accepting


def test_fault_plan_validation_and_counters():
    with pytest.raises(ValueError, match="fail_every"):
        rz.FaultPlan(fail_every=0)
    plan = rz.FaultPlan(fail_every=2)
    x = np.zeros((1, 2, 2, 1), np.float32)
    plan.apply(x, _noop)
    with pytest.raises(FaultInjected, match="transient"):
        plan.apply(x, _noop)
    assert plan.injected["transient"] == 1 and plan.total_injected == 1


# ---------------------------------------------------------------------------
# Admission control + deadlines.
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_admission_bound_never_exceeded(server):
    before = dict(server.stats())
    q = _queue(server, FakeClock(), max_batch=64, max_pending=8)
    depths, tickets = [], []
    for _ in range(14):
        tickets.append(q.submit(_req(server)))
        depths.append(q.pending_images)
    assert max(depths) <= 8
    rejected = [t for t in tickets if isinstance(t.error, rz.AdmissionError)]
    assert len(rejected) == 6
    assert all(t.done for t in rejected)
    q.flush()
    assert all(t.done for t in tickets)
    assert server.stats()["rejected"] - before["rejected"] == 6


@pytest.mark.chaos
def test_admission_flush_mode_applies_backpressure(server):
    before = dict(server.stats())
    q = _queue(server, FakeClock(), max_batch=64, max_pending=4,
               admission="flush")
    tickets = [q.submit(_req(server)) for _ in range(10)]
    q.flush()
    assert all(t.ok for t in tickets)
    assert server.stats()["rejected"] == before["rejected"]


def test_oversized_request_rejected_even_when_empty(server):
    q = _queue(server, FakeClock(), max_batch=64, max_pending=4)
    t = q.submit(_req(server, 5))
    assert isinstance(t.error, rz.AdmissionError)
    assert q.pending_images == 0


def test_malformed_request_raises_at_submit(server):
    q = _queue(server, FakeClock())
    with pytest.raises(ValueError, match="item shape"):
        q.submit(np.zeros((1, 3, 3, 1), np.float32))
    with pytest.raises(ValueError, match="empty"):
        q.submit(np.zeros((0,) + server.item_shape, np.float32))
    with pytest.raises(ValueError, match="admission"):
        _queue(server, FakeClock(), admission="drop")
    with pytest.raises(ValueError, match="item shape"):
        server.infer(np.zeros((1, 3, 3, 1), np.float32))


@pytest.mark.chaos
def test_expired_deadline_sheds_before_flush(server):
    before = dict(server.stats())
    clock = FakeClock()
    q = _queue(server, clock)
    t_dead = q.submit(_req(server), deadline_s=0.005)
    t_live = q.submit(_req(server))
    clock.advance(0.010)
    q.flush()
    assert isinstance(t_dead.error, rz.DeadlineExceeded)
    assert t_dead.done and not t_dead.ok
    assert t_dead.latency_s == pytest.approx(0.010)
    assert t_live.ok
    assert server.stats()["shed"] - before["shed"] == 1


def test_default_deadline_applies_to_all_submits(server):
    clock = FakeClock()
    q = _queue(server, clock, default_deadline_s=0.002)
    t = q.submit(_req(server))
    clock.advance(0.003)
    q.poll()
    assert isinstance(t.error, rz.DeadlineExceeded)
    assert q.pending_images == 0


# ---------------------------------------------------------------------------
# Bisecting quarantine.
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_poison_request_quarantined_in_log_flushes_healthy_bit_exact(server):
    before = dict(server.stats())
    n, poison_at = 32, 11
    reqs = [_req(server) for _ in range(n)]
    reqs[poison_at][:] = np.nan
    retry = rz.RetryPolicy(max_retries=1, backoff_s=0.001)
    plan = rz.FaultPlan(poison_nan=True)
    chaos = rz.ChaosServer(server, plan, delay=_noop)
    q = _queue(chaos, FakeClock(), max_batch=n, retry=retry)
    tickets = [q.submit(r) for r in reqs]
    assert all(t.done for t in tickets)
    poisoned = tickets[poison_at]
    assert isinstance(poisoned.error, rz.RequestPoisoned)
    assert isinstance(poisoned.error.__cause__, FaultInjected)
    assert all(t.ok for i, t in enumerate(tickets) if i != poison_at)
    for i, (r, t) in enumerate(zip(reqs, tickets)):
        if i == poison_at:
            continue
        ref = api.oracle(server.qnet, torch.from_numpy(r), mode="packed")
        assert torch.equal(t.result, ref)
    assert q.flushes - 1 <= math.ceil(math.log2(n)) + 1
    assert plan.calls <= 1 + 2 * math.ceil(math.log2(n)) + retry.max_retries
    after = server.stats()
    assert after["quarantined"] - before["quarantined"] == 1
    assert after["retried"] - before["retried"] == retry.max_retries
    assert plan.injected["poison"] == (
        1 + math.ceil(math.log2(n)) + retry.max_retries)
    assert plan.injected["transient"] == 0


@pytest.mark.chaos
def test_two_poison_requests_both_quarantined(server):
    before = dict(server.stats())
    n = 16
    reqs = [_req(server) for _ in range(n)]
    reqs[2][:] = np.nan
    reqs[13][:] = np.nan
    chaos = rz.ChaosServer(server, rz.FaultPlan(poison_nan=True),
                           delay=_noop)
    q = _queue(chaos, FakeClock(), max_batch=n,
               retry=rz.RetryPolicy(max_retries=0))
    tickets = [q.submit(r) for r in reqs]
    assert all(t.done for t in tickets)
    assert isinstance(tickets[2].error, rz.RequestPoisoned)
    assert isinstance(tickets[13].error, rz.RequestPoisoned)
    assert sum(t.ok for t in tickets) == n - 2
    assert server.stats()["quarantined"] - before["quarantined"] == 2


@pytest.mark.chaos
def test_poison_at_head_of_batch_server_stays_accepting(server):
    """One fault event is one unhealthy sample: a poison leading the
    batch degrades the server but does not drain it."""
    before = dict(server.stats())
    n = 8
    reqs = [_req(server) for _ in range(n)]
    reqs[0][:] = np.nan
    chaos = rz.ChaosServer(server, rz.FaultPlan(poison_nan=True),
                           delay=_noop)
    q = _queue(chaos, FakeClock(), max_batch=n,
               retry=rz.RetryPolicy(max_retries=2, backoff_s=0.001))
    assert q.health.drain_after == 4
    tickets = [q.submit(r) for r in reqs]
    assert isinstance(tickets[0].error, rz.RequestPoisoned)
    assert all(t.ok for t in tickets[1:])
    assert q.health.state == rz.DEGRADED
    assert q.health.accepting
    follow_up = q.submit(_req(server))
    assert follow_up.error is None
    q.flush()
    assert follow_up.ok
    assert server.stats()["quarantined"] - before["quarantined"] == 1


@pytest.mark.chaos
def test_retry_path_respects_deadline(server):
    before = dict(server.stats())
    chaos = rz.ChaosServer(server, rz.FaultPlan(poison_nan=True),
                           delay=_noop)
    q = _queue(chaos, FakeClock(),
               retry=rz.RetryPolicy(max_retries=4, backoff_s=1.0,
                                    backoff_mult=1.0))
    r = _req(server)
    r[:] = np.nan
    t = q.submit(r, deadline_s=1.5)
    q.flush()
    assert isinstance(t.error, rz.DeadlineExceeded)
    assert t.done and not t.ok
    after = server.stats()
    assert after["shed"] - before["shed"] == 1
    assert after["quarantined"] == before["quarantined"]
    assert after["retried"] - before["retried"] == 2


@pytest.mark.chaos
def test_degraded_flushes_counts_executed_groups_only(server):
    before = dict(server.stats())
    chaos = rz.ChaosServer(server, rz.FaultPlan(poison_nan=True),
                           delay=_noop)
    q = _queue(chaos, FakeClock(), retry=rz.RetryPolicy(max_retries=0))
    reqs = [_req(server) for _ in range(4)]
    reqs[0][:] = np.nan
    tickets = [q.submit(r) for r in reqs]
    q.flush()
    assert isinstance(tickets[0].error, rz.RequestPoisoned)
    assert all(t.ok for t in tickets[1:])
    assert server.stats()["degraded_flushes"] == before["degraded_flushes"]


@pytest.mark.chaos
def test_poison_never_splits_a_multi_image_request(server):
    reqs = [_req(server, 2), _req(server, 3), _req(server, 2)]
    reqs[1][:] = np.nan
    chaos = rz.ChaosServer(server, rz.FaultPlan(poison_nan=True),
                           delay=_noop)
    q = _queue(chaos, FakeClock(), retry=rz.RetryPolicy(max_retries=0))
    tickets = [q.submit(r) for r in reqs]
    q.flush()
    assert tickets[0].ok and tickets[2].ok
    assert isinstance(tickets[1].error, rz.RequestPoisoned)
    assert tickets[1].size == 3


# ---------------------------------------------------------------------------
# Transient faults, the health machine.
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_fail_every_nth_flush_all_tickets_recover(server):
    before = dict(server.stats())
    plan = rz.FaultPlan(fail_every=3)
    chaos = rz.ChaosServer(server, plan, delay=_noop)
    q = _queue(chaos, FakeClock(), max_batch=1, timeout_s=0.0,
               retry=rz.RetryPolicy(max_retries=2, backoff_s=0.0))
    tickets = [q.submit(_req(server)) for _ in range(12)]
    q.flush()
    assert all(t.ok for t in tickets)
    after = server.stats()
    assert plan.injected["transient"] > 0
    assert after["retried"] - before["retried"] == plan.injected["transient"]
    assert after["quarantined"] == before["quarantined"]


@pytest.mark.chaos
def test_latency_spike_degrades_then_recovers(server):
    before = dict(server.stats())
    clock = FakeClock()
    plan = rz.FaultPlan(latency_every=5, latency_s=0.5, base_latency_s=0.01)
    chaos = rz.ChaosServer(server, plan, delay=clock.advance)
    health = rz.HealthMonitor(
        StragglerMonitor(window=16, threshold=3.0, warmup=2),
        drain_after=10, recover_after=2)
    q = _queue(chaos, clock, max_batch=4, health=health,
               degraded_max_batch=2)

    def round_of_four():
        return [q.submit(_req(server)) for _ in range(4)]

    for _ in range(4):
        assert all(t.ok for t in round_of_four())
    assert health.state == rz.HEALTHY
    assert all(t.ok for t in round_of_four())
    assert health.state == rz.DEGRADED
    assert plan.injected["latency"] == 1
    assert all(t.ok for t in round_of_four())
    assert server.stats()["degraded_flushes"] - before["degraded_flushes"] \
        == 2
    assert health.state == rz.HEALTHY


@pytest.mark.chaos
def test_shard_loss_served_through_degraded_small_batches(server):
    before = dict(server.stats())
    plan = rz.FaultPlan(shard_loss_after=0, shard_rows=2)
    chaos = rz.ChaosServer(server, plan, delay=_noop)
    health = rz.HealthMonitor(
        StragglerMonitor(window=16, threshold=4.0, warmup=2),
        drain_after=10, recover_after=32)
    q = _queue(chaos, FakeClock(), max_batch=8, health=health,
               degraded_max_batch=2, retry=rz.RetryPolicy(max_retries=0))
    first_wave = [q.submit(_req(server)) for _ in range(8)]
    q.flush()
    assert all(t.ok for t in first_wave)
    assert health.state == rz.DEGRADED
    assert plan.injected["shard"] > 0
    second_wave = [q.submit(_req(server)) for _ in range(6)]
    q.flush()
    assert all(t.ok for t in second_wave)
    after = server.stats()
    assert after["degraded_flushes"] - before["degraded_flushes"] >= 3
    assert after["quarantined"] == before["quarantined"]


@pytest.mark.chaos
def test_draining_refuses_admissions_until_resume(server):
    before = dict(server.stats())
    health = rz.HealthMonitor(drain_after=1, recover_after=1)
    q = _queue(server, FakeClock(), health=health)
    pending = q.submit(_req(server))
    health.record_failure()
    assert health.state == rz.DRAINING
    refused = q.submit(_req(server))
    assert isinstance(refused.error, rz.AdmissionError)
    assert "draining" in str(refused.error)
    q.flush()
    assert pending.ok
    assert server.stats()["rejected"] - before["rejected"] == 1
    health.resume()
    accepted = q.submit(_req(server))
    q.flush()
    assert accepted.ok


@pytest.mark.chaos
def test_run_request_stream_under_chaos_resolves_everything(server):
    before = dict(server.stats())
    plan = rz.FaultPlan(fail_every=4)
    chaos = rz.ChaosServer(server, plan, delay=_noop)
    q = _queue(chaos, FakeClock(), max_batch=4, timeout_s=0.0,
               retry=rz.RetryPolicy(max_retries=2, backoff_s=0.0))
    tickets = serve_cnn.run_request_stream(q, [1, 2, 1, 3, 1, 1, 2, 1],
                                           seed=3)
    assert all(t.done for t in tickets)
    assert all(t.ok for t in tickets)
    assert q.pending_images == 0
    after = server.stats()
    # timeout 0 flushes every submit alone, so each fault is one retry
    assert after["retried"] - before["retried"] == plan.injected["transient"]
    assert plan.injected["transient"] == plan.total_injected > 0


# ---------------------------------------------------------------------------
# Engine and executable plumbing.
# ---------------------------------------------------------------------------


def test_plan_cache_failures_counter(server):
    def broken_compile(qnet, shape):
        def plan(x):
            raise RuntimeError("dead shard")
        return plan

    cache = engine.PlanCache((1, 4), method="jnp", compile_fn=broken_compile)
    with pytest.raises(RuntimeError, match="dead shard"):
        cache.run(server.qnet, torch.zeros((2,) + server.item_shape))
    assert cache.stats.failures == 1
    assert cache.stats.executions == 0


def test_executable_attach_stats_merges_provider(server):
    assert server.stats()["rejected"] >= 0
    exe = server.exe
    exe.attach_stats(lambda: {"custom_probe": 7})
    try:
        assert server.stats()["custom_probe"] == 7
    finally:
        exe._stat_providers.pop()


def test_executable_attach_stats_rejects_key_collision(server):
    exe = server.exe
    exe.attach_stats(lambda: {"failures": 999})
    try:
        with pytest.raises(ValueError, match="failures.*collide"):
            server.stats()
    finally:
        exe._stat_providers.pop()
    exe.attach_stats(lambda: {"rejected": 1})
    try:
        with pytest.raises(ValueError, match="rejected.*collide"):
            server.stats()
    finally:
        exe._stat_providers.pop()


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

BAD_ARGV = {
    "no-arch": [],
    "unknown-arch": ["--arch", "resnet"],
    "requests-zero": ["--arch", "lenet5", "--requests", "0"],
    "max-request-zero": ["--arch", "lenet5", "--max-request", "0"],
    "negative-timeout": ["--arch", "lenet5", "--timeout-ms", "-1"],
    "zero-deadline": ["--arch", "lenet5", "--deadline-ms", "0"],
    "zero-pending": ["--arch", "lenet5", "--max-pending", "0"],
    "negative-retries": ["--arch", "lenet5", "--retries", "-1"],
    "zero-steps": ["--arch", "lenet5", "--num-steps", "0"],
    "unsorted-buckets": ["--arch", "lenet5", "--buckets", "8,1"],
    "duplicate-buckets": ["--arch", "lenet5", "--buckets", "1,1,8"],
    "non-int-buckets": ["--arch", "lenet5", "--buckets", "1,x"],
    "zero-data-parallel": ["--arch", "lenet5", "--data-parallel", "0"],
    # the planner's constraints: the reference validates them, the port
    # (no planner yet) has no such flags, so argparse refuses them
    "floor-without-auto": ["--arch", "lenet5", "--accuracy-floor", "0.9"],
    "auto-with-encoding": ["--arch", "lenet5", "--auto", "--encoding",
                           "rate"],
    "auto-bad-floor": ["--arch", "lenet5", "--auto", "--accuracy-floor",
                       "1.5"],
    "unknown-encoding": ["--arch", "lenet5", "--encoding", "delta"],
}


@pytest.mark.parametrize("case", sorted(BAD_ARGV))
def test_cli_argument_errors_exit_2(case):
    with pytest.raises(SystemExit) as err:
        serve_cnn._parse_args(BAD_ARGV[case])
    assert err.value.code == 2
    with pytest.raises(SystemExit):
        jserve._parse_args(BAD_ARGV[case])


def test_cli_refuses_what_is_not_ported():
    base = ["--arch", "lenet5", "--smoke", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_cnn.main(base + ["--auto"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_cnn.main(base + ["--data-parallel", "2"])
    with pytest.raises(ValueError, match="phase coding only"):
        serve_cnn.main(base + ["--periods", "2"])
    with pytest.raises(ValueError):       # rate on kernels, validated
        serve_cnn.main(base + ["--encoding", "rate", "--pool-mode", "avg",
                               "--backend", "kernels"])
    with pytest.raises(ValueError):       # ttfs does not preserve "or"
        serve_cnn.main(base + ["--encoding", "ttfs"])
    for name, steps, periods in (("delta", 4, 1), ("radix", 4, 2)):
        with pytest.raises(ValueError):
            serve_cnn.make_encoding(name, steps, periods=periods)
    assert serve_cnn.make_encoding("phase", 8, periods=2) == \
        api.PhaseEncoding(8, periods=2)


@pytest.mark.parametrize("argv,backend", [
    (["--arch", "fang_cnn", "--encoding", "ttfs", "--pool-mode", "avg",
      "--dataflow", "bitserial"], "kernels"),
    (["--arch", "lenet5", "--encoding", "rate", "--pool-mode", "avg"],
     "jnp"),
])
def test_cli_serves_every_request_on_cpu(argv, backend, capsys,
                                        monkeypatch):
    # the CLI's queue times flushes by the wall clock; a straggler window
    # that flags nothing keeps a loaded test machine from degrading or
    # draining it, so every request must be served
    health = rz.HealthMonitor
    monkeypatch.setattr(
        rz, "HealthMonitor",
        lambda: health(StragglerMonitor(threshold=1e9)))
    out = serve_cnn.main(argv + ["--smoke", "--device", "cpu", "--requests",
                                 "10", "--buckets", "1,4,8"])
    assert out["ok"] == out["requests"] == 10
    assert out["stats"]["compiles"] == 3          # the warmed ladder only
    assert out["stats"]["failures"] == 0 and out["health"] == "healthy"
    assert f"backend={backend}" in capsys.readouterr().out
