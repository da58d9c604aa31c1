"""The port's threaded runtimes (``repro_torch.core.runtime``) against the
reference's, and the eight chaos cases of ``tests/test_runtime_chaos.py``
mirrored on the port.

With one worker a runtime is deterministic, so it is held against the
reference: taus exact, gammas bitwise, the objective within ``OBJ_REL``
of its start (the port's worker gradient is closed form, the reference's
autodiff).  With several workers the delays are the machine's own; the
logs must satisfy the step-size principle (Eq. 8).  The chaos cases use
heartbeats of at most 0.5 s so that none waits long, and the reference's
bounds on the time a crash takes to surface (5 s, 10 s when all die).
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

from repro.core import (Adaptive1 as JA1, L1 as JL1, PIAGServer as JPIAG,
                        SharedMemoryBCD as JBCD, make_logreg as jml)
from repro_torch.core import (Adaptive1, Adaptive2, L1, PIAGServer,
                              SharedMemoryBCD, check_principle, make_lasso,
                              make_logreg)
from repro_torch.core.runtime import RunLog, WorkerCrash

OBJ_REL = 1e-5
HEARTBEAT = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    return make_logreg(240, 40, n_workers=4, seed=0, device="cpu")


@pytest.fixture(scope="module")
def policy(problem):
    return Adaptive1(gamma_prime=0.99 / problem.L)


@pytest.fixture(scope="module")
def prox(problem):
    return L1(lam=problem.lam1)


def _against_reference(jlog, tlog):
    assert tlog.taus == jlog.taus
    assert [np.float32(g).view(np.int32) for g in tlog.gammas] == \
        [np.float32(g).view(np.int32) for g in jlog.gammas]
    jo, to = np.asarray(jlog.objective), np.asarray(tlog.objective)
    assert jo.shape == to.shape
    assert np.abs(jo - to).max() <= OBJ_REL * abs(jo[0])


@pytest.mark.parametrize("record_every", [1, 7])
def test_piag_server_one_worker_matches_reference(record_every):
    jp = jml(240, 40, n_workers=4, seed=0)
    tp = make_logreg(240, 40, n_workers=4, seed=0, device="cpu")
    gp = 0.99 / jp.L
    jlog = JPIAG(jp, JA1(gamma_prime=gp), JL1(lam=jp.lam1), n_workers=1,
                 record_every=record_every).run(120)
    srv = PIAGServer(tp, Adaptive1(gamma_prime=gp), L1(lam=tp.lam1),
                     n_workers=1, record_every=record_every, device="cpu")
    tlog = srv.run(120)
    _against_reference(jlog, tlog)
    assert [list(t) for t in tlog.taus_per_worker] == \
        [list(t) for t in jlog.taus_per_worker]
    assert tlog.in_flight_max == 1 and srv.x_final.shape == (40,)


@pytest.mark.parametrize("m_blocks", [5, 7])
def test_shared_memory_bcd_one_worker_matches_reference(m_blocks):
    jp = jml(240, 40, n_workers=4, seed=0)
    tp = make_logreg(240, 40, n_workers=4, seed=0, device="cpu")
    gp = 0.99 / jp.Lhat
    jlog = JBCD(jp, JA1(gamma_prime=gp), JL1(lam=jp.lam1), n_workers=1,
                m_blocks=m_blocks, seed=3).run(120)
    bcd = SharedMemoryBCD(tp, Adaptive1(gamma_prime=gp), L1(lam=tp.lam1),
                          n_workers=1, m_blocks=m_blocks, seed=3,
                          device="cpu")
    tlog = bcd.run(120)
    _against_reference(jlog, tlog)
    assert tlog.in_flight_max == 1


@pytest.mark.parametrize("runtime", ["piag", "bcd"])
def test_threaded_logs_satisfy_the_principle(problem, prox, runtime):
    """Several workers on real threads: the delays are this machine's, the
    gammas obey Eq. (8) at the policy's gamma', every write event is
    logged, and the objective falls; on a lasso too."""
    for prob, px in ((problem, prox),
                     (make_lasso(240, 40, n_workers=4, seed=0, device="cpu"),
                      L1(lam=1e-3))):
        if runtime == "piag":
            gp = 0.99 / prob.L
            rt = PIAGServer(prob, Adaptive2(gamma_prime=gp), px,
                            n_workers=4, device="cpu")
        else:
            gp = 0.99 / prob.block_smoothness(5)
            rt = SharedMemoryBCD(prob, Adaptive2(gamma_prime=gp), px,
                                 n_workers=4, m_blocks=5, device="cpu")
        log = rt.run(200)
        assert len(log.taus) == len(log.gammas) == len(log.objective) == 200
        assert check_principle(log.gammas, log.taus, np.float32(gp))
        assert log.objective[-1] < log.objective[0]
        assert 1 <= log.in_flight_max <= 4


@pytest.mark.timeout(120)
def test_more_threads_than_cores_under_a_short_switch_interval():
    """More worker threads than cores, the interpreter switching threads
    every 10 us: every write event is logged once, the delays are
    consistent with the write counter and the gammas obey Eq. (8) -- a
    lost update of the counter or of the step-size state under the lock
    would break these."""
    n = (os.cpu_count() or 4) + 4
    prob = make_logreg(40 * n, 40, n_workers=n, seed=1, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        gp = 0.99 / prob.block_smoothness(5)
        bcd = SharedMemoryBCD(prob, Adaptive1(gamma_prime=gp),
                              L1(lam=prob.lam1), n_workers=n, m_blocks=5,
                              device="cpu")
        blog = bcd.run(300)
        srv = PIAGServer(prob, Adaptive1(gamma_prime=0.99 / prob.L),
                         L1(lam=prob.lam1), n_workers=n, heartbeat=30.0,
                         device="cpu")
        plog = srv.run(300)
    finally:
        sys.setswitchinterval(old)
    assert len(blog.taus) == len(blog.gammas) == len(blog.objective) == 300
    assert all(0 <= t <= k for k, t in enumerate(blog.taus))
    assert check_principle(blog.gammas, blog.taus, np.float32(gp))
    assert np.isfinite(bcd.x_final).all()
    assert len(plog.taus) == 300 and plog.crashes == 0
    assert all(len(t) == n and t.min() >= 0 and t.max() <= k
               for k, t in enumerate(plog.taus_per_worker))
    assert plog.taus == [int(t.max()) for t in plog.taus_per_worker]
    assert check_principle(plog.gammas, plog.taus,
                           np.float32(0.99 / prob.L))


# ------------------------------------------------ the chaos cases ----


def test_healthy_run_reports_zero_incidents(problem, policy, prox):
    srv = PIAGServer(problem, policy, prox, n_workers=4, record_every=10,
                     heartbeat=HEARTBEAT, device="cpu")
    log = srv.run(100)
    assert len(log.objective) == 10
    assert log.crashes == 0 and log.respawns == 0 and log.join_failures == 0
    assert np.all(np.isfinite(np.asarray(log.objective)))


@pytest.mark.timeout(30)
def test_killed_worker_raises_within_heartbeat(problem, policy, prox):
    """A worker dies mid-run -> WorkerCrash on the master, chained to the
    worker's own exception, inside the heartbeat."""
    calls = {"n": 0}

    def killer(i):
        calls["n"] += 1
        if i == 1 and calls["n"] > 6:
            raise RuntimeError("injected kill")
        return 0.0

    srv = PIAGServer(problem, policy, prox, n_workers=4, worker_sleep=killer,
                     heartbeat=HEARTBEAT, device="cpu")
    t0 = time.perf_counter()
    with pytest.raises(WorkerCrash) as ei:
        srv.run(2000)
    elapsed = time.perf_counter() - t0
    assert elapsed < 5.0, f"crash took {elapsed:.1f}s to surface"
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert "injected kill" in str(ei.value.__cause__)


@pytest.mark.timeout(60)
def test_all_workers_dead_raises_not_hangs(problem, policy, prox):
    def kill_all(i):
        raise RuntimeError("everyone dies")

    srv = PIAGServer(problem, policy, prox, n_workers=4,
                     worker_sleep=kill_all, heartbeat=HEARTBEAT, device="cpu")
    t0 = time.perf_counter()
    with pytest.raises((WorkerCrash, TimeoutError)):
        srv.run(100)
    assert time.perf_counter() - t0 < 10.0


@pytest.mark.timeout(60)
def test_respawn_revives_crashed_worker(problem, policy, prox):
    """respawn=True: the crashed worker is revived, its DelayTracker entry
    re-stamped at the current write count, and the run completes with the
    incident counted."""
    state = {"killed": False}

    def kill_once(i):
        if i == 2 and not state["killed"]:
            state["killed"] = True
            raise RuntimeError("transient death")
        return 0.0

    srv = PIAGServer(problem, policy, prox, n_workers=4,
                     worker_sleep=kill_once, respawn=True,
                     heartbeat=HEARTBEAT, device="cpu")
    log = srv.run(200, x0=None)
    assert log.crashes == 1 and log.respawns == 1
    assert len(log.objective) == 200
    assert np.all(np.isfinite(np.asarray(log.objective)))
    # a rejoined worker was re-stamped: delays stay bounded by the run
    assert max(log.taus) < 200


@pytest.mark.timeout(60)
def test_respawn_budget_exhausts_to_crash(problem, policy, prox):
    def always_kill(i):
        if i == 0:
            raise RuntimeError("persistent death")
        return 0.0

    srv = PIAGServer(problem, policy, prox, n_workers=4,
                     worker_sleep=always_kill, respawn=True, max_respawns=2,
                     heartbeat=HEARTBEAT, device="cpu")
    with pytest.raises(WorkerCrash):
        srv.run(2000)


@pytest.mark.timeout(60)
def test_bcd_worker_exception_propagates(problem, policy):
    """The BCD master would spin forever on the write counter when a worker
    died; the boxed exception re-raises chained."""
    base = L1(lam=problem.lam1)

    class BadProx:
        calls = 0

        def prox(self, v, gamma):
            BadProx.calls += 1
            if BadProx.calls > 10:
                raise RuntimeError("bcd injected kill")
            return base.prox(v, gamma)

    bcd = SharedMemoryBCD(problem, policy, BadProx(), n_workers=4,
                          m_blocks=5, device="cpu")
    t0 = time.perf_counter()
    with pytest.raises(WorkerCrash) as ei:
        bcd.run(100000)
    assert time.perf_counter() - t0 < 10.0
    assert "bcd injected kill" in str(ei.value.__cause__)


def test_bcd_healthy_run_unaffected(problem, policy, prox):
    bcd = SharedMemoryBCD(problem, policy, prox, n_workers=4, m_blocks=5,
                          record_every=10, device="cpu")
    log = bcd.run(100)
    assert len(log.objective) == 10
    assert log.crashes == 0 and log.join_failures == 0


def test_runlog_incident_fields_default_zero():
    log = RunLog()
    assert (log.crashes, log.respawns, log.join_failures) == (0, 0, 0)
    assert log.in_flight_max == 0
    # as_arrays is unchanged: four columns, incident counters stay scalar
    assert len(log.as_arrays()) == 4
