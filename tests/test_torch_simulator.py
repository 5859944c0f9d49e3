"""The port's simulator substrate against the JAX package's.

``repro_torch.core``'s topology (on the stdlib graph), event simulator,
cluster monitor, negotiation protocols, baselines, ``Topology``-based plan
builders and the ablation baselines of ``sharding_alg`` are copies of the
JAX package's modules, and plain Python arithmetic on both sides: every
output is compared with ``==`` on the same topologies, seeds and inputs.
The first nine tests are ``tests/test_simulator.py``'s, run on the port.
Last, ``chip_smoke.simulator_sweep`` through the JAX package must give the
pinned ``SIMULATOR_DIGEST`` that the card phase holds the port to, and
through the port the same digest.
"""
import dataclasses
import importlib.util
import pathlib
import random
import sys
from types import SimpleNamespace

import pytest

import repro.core.baselines
import repro.core.engine
import repro.core.monitor
import repro.core.negotiation
import repro.core.plans
import repro.core.sharding_alg
import repro.core.simulator
import repro.core.topology
from repro_torch.core import (baselines, engine, monitor, negotiation, plans,
                              sharding_alg, simulator, topology)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MB = 1024 * 1024

_NAMES = ("topology", "simulator", "monitor", "negotiation", "baselines",
          "plans", "sharding_alg", "engine")
JAX = SimpleNamespace(**{n: getattr(repro.core, n) for n in _NAMES})
PORT = SimpleNamespace(topology=topology, simulator=simulator, monitor=monitor,
                       negotiation=negotiation, baselines=baselines,
                       plans=plans, sharding_alg=sharding_alg, engine=engine)
BOTH = (JAX, PORT)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


# -- tests/test_simulator.py on the port ----------------------------------------

Link, Topology = topology.Link, topology.Topology


def _cluster(n=6, strategy="chaos", state=200 * MB, seed=0):
    topo = topology.random_edge_topology(n, seed=seed)
    sizes = [4 * MB] * (state // (4 * MB))
    return baselines.make_cluster(topo, state_bytes=state, tensor_sizes=sizes,
                                  strategy=strategy)


def _join_links(topo, new, n_links=3, seed=0):
    rng = random.Random(seed)
    peers = rng.sample(sorted(topo.active_nodes()),
                       min(n_links, len(topo.active_nodes())))
    return {p: Link(rng.uniform(100, 1000), rng.uniform(0.001, 0.02))
            for p in peers}


def test_sim_event_ordering():
    sim = simulator.Sim()
    order = []
    sim.after(2.0, lambda: order.append("b"))
    sim.after(1.0, lambda: order.append("a"))
    sim.after(3.0, lambda: order.append("c"))
    sim.run()
    assert order == ["a", "b", "c"]
    assert sim.now == pytest.approx(3.0)


def test_network_link_fifo_contention():
    """Two transfers sharing one link serialize (store-and-forward FIFO)."""
    topo = Topology()
    for i in range(3):
        topo.add_node(i)
    topo.add_link(0, 2, Link(800, 0.001))
    topo.add_link(1, 0, Link(800, 0.001))
    sim = simulator.Sim()
    net = simulator.Network(sim, topo)
    done = {}
    nbytes = 100 * MB
    net.transfer([0, 2], nbytes, lambda t: done.setdefault("direct", t))
    net.transfer([1, 0, 2], nbytes, lambda t: done.setdefault("twohop", t))
    sim.run()
    one_link_time = nbytes / (800 * 1e6 / 8)
    assert done["direct"] == pytest.approx(0.001 + one_link_time, rel=1e-6)
    assert done["twohop"] >= 2 * one_link_time


def test_training_barrier_idle_accounting():
    topo = Topology()
    topo.add_node(0, compute_s=1.0)
    topo.add_node(1, compute_s=2.0)
    topo.add_link(0, 1, Link(1000, 0.001))
    sim = simulator.Sim()
    net = simulator.Network(sim, topo)
    sess = simulator.TrainingSession(sim, net, topo, state_bytes=10 * MB)
    idle = sess.run_iterations(3)
    assert idle[0] == pytest.approx(3.0)
    assert idle[1] == pytest.approx(0.0)


def test_scale_out_chaos_faster_than_alternatives():
    state = 400 * MB
    delays, idles = {}, {}
    for strat in ("chaos", "single-source", "multi-source", "pollux"):
        cl = _cluster(8, strat, state)
        cl.train(2)
        links = _join_links(cl.topo, 100, 3, seed=1)
        d, idle, _ = baselines.run_scale_out(cl, strat, 100, links, state)
        delays[strat] = d
        idles[strat] = sum(idle.values())
    assert delays["chaos"] < delays["single-source"]
    assert delays["chaos"] < delays["multi-source"]
    assert delays["chaos"] < delays["pollux"]
    assert delays["pollux"] > 90.0
    assert idles["chaos"] < idles["single-source"] < idles["pollux"]


def test_scale_out_activates_node():
    cl = _cluster(6, "chaos")
    cl.train(1)
    n0 = len(cl.topo.active_nodes())
    res = cl.scale_out(50, _join_links(cl.topo, 50, 3))
    assert len(cl.topo.active_nodes()) == n0 + 1
    assert res.delay_s > 0
    assert res.plan.sources
    assert res.solver_s < 1.0


def test_scale_in_under_1ms():
    cl = _cluster(6, "chaos")
    cl.train(1)
    victim = [n for n in cl.topo.active_nodes() if n != cl.scheduler.node][0]
    res = cl.scale_in(victim)
    assert res.delay_s < 1e-3
    assert victim not in cl.topo.active_nodes()


def test_connect_and_disconnect_link_under_1ms():
    cl = _cluster(8, "chaos")
    cl.train(1)
    nodes = cl.topo.active_nodes()
    u, v = nodes[0], nodes[-1]
    if cl.topo.has_link(u, v):
        cl.topo.remove_link(u, v)
    r1 = cl.connect_link(u, v, Link(500, 0.005))
    assert r1.delay_s < 1e-3
    assert cl.topo.has_link(u, v)
    r2 = cl.disconnect_link(u, v)
    assert r2.delay_s < 1e-3
    assert not cl.topo.has_link(u, v)


def test_node_failure_detected_by_heartbeat():
    cl = _cluster(6, "chaos")
    cl.train(1)
    mon = cl.scheduler.monitor
    for n in cl.topo.active_nodes():
        mon.heartbeat(n)
    victim = [n for n in cl.topo.active_nodes() if n != cl.scheduler.node][0]
    cl.sim.after(monitor.HEARTBEAT_TIMEOUT_S + 1, lambda: None)
    cl.sim.run()
    for n in cl.topo.active_nodes():
        if n != victim:
            mon.heartbeat(n)
    assert mon.check_heartbeats() == [victim]
    assert victim not in cl.topo.active_nodes()


def test_pollux_idle_scales_with_cluster():
    small = baselines.pollux_scale_out(topology.random_edge_topology(6, seed=0),
                                       400 * MB)
    big = baselines.pollux_scale_out(topology.random_edge_topology(12, seed=0),
                                     400 * MB)
    assert sum(big.idle_s.values()) > sum(small.idle_s.values())


# -- parity with the JAX package, module by module -------------------------------


@pytest.mark.parametrize("n, seed", [(n, s) for n in (6, 8, 10, 12) for s in (0, 1)]
                         + [(32, "pod")])
def test_snapshot_after_reshuffle_matches_jax(n, seed):
    """Construction, ``reshuffle_bandwidths`` (one draw per edge in edge
    order) and ``snapshot`` (keys in that order)."""
    snaps = []
    for core in BOTH:
        if seed == "pod":
            topo = core.topology.pod_topology(n)
        else:
            topo = core.topology.random_edge_topology(n, seed=seed)
        first = topo.snapshot()
        core.topology.reshuffle_bandwidths(topo, seed=7)
        snaps.append((first, topo.snapshot(), list(topo.snapshot()["links"]),
                      topo.version))
    assert snaps[0] == snaps[1]


def _network_run(core, loss):
    """Bulk transfers along shortest routes and control datagrams, staggered
    so that links contend, one stream cancelled mid-flight, one lossy link
    set and cleared, and a routed control message."""
    topo = core.topology.random_edge_topology(8, seed=3)
    sim = core.simulator.Sim()
    net = core.simulator.Network(sim, topo)
    rng = random.Random(5)
    done, handles = [], {}
    for i in range(14):
        u, v = rng.sample(range(8), 2)
        route = topo.shortest_path(u, v, 8 * MB)
        nbytes = rng.choice((MB, 8 * MB, 32 * MB))
        contend = i % 3 != 0

        def go(i=i, route=route, nbytes=nbytes, contend=contend):
            handles[i] = net.transfer(route, nbytes,
                                      lambda t, i=i: done.append((i, t)),
                                      contend=contend)

        sim.at(rng.uniform(0.0, 0.5), go)
    key = next(iter(topo.g.edges))
    if loss:
        sim.at(0.2, lambda: net.set_link_loss(*key, 0.3))
        sim.at(1.5, lambda: net.clear_link_loss(*key))
    sim.at(0.6, lambda: handles[2].cancel(sim.now))
    net.control(0, 7, lambda: done.append(("control", sim.now)))
    sim.run()
    return (done, {i: (h.done_t, h.cancelled, h.cancelled_delivered,
                       h.t_first_byte, h.byte_rate, h.progress(1.0))
                   for i, h in sorted(handles.items())},
            net.metrics_snapshot(), net.metrics_snapshot(now=0.7),
            sorted(net._link_free.items()), sim.now)


@pytest.mark.parametrize("loss", [False, True])
def test_network_transfer_times_match_jax(loss):
    assert _network_run(PORT, loss) == _network_run(JAX, loss)


def _session_run(core, n):
    topo = core.topology.random_edge_topology(n, seed=n)
    sim = core.simulator.Sim()
    net = core.simulator.Network(sim, topo)
    sess = core.simulator.TrainingSession(sim, net, topo, state_bytes=64 * MB)
    seen = []
    sess.on_iteration(seen.append)
    sess.run_iterations(2)
    sess.inject_stall(1, 0.75)
    sess.run_iterations(2)
    return (sess.idle, sess.sync_skew, sess.events.allreduce_done,
            sess.allreduce_time(), seen, sim.now)


@pytest.mark.parametrize("n", [4, 6, 12])
def test_training_session_idle_matches_jax(n):
    assert _session_run(PORT, n) == _session_run(JAX, n)


def _scale_outs(core, strategy, codec):
    out = []
    for n in (6, 8, 10, 12):
        for seed in (0, 1):
            topo = core.topology.random_edge_topology(n, seed=seed)
            cl = core.baselines.make_cluster(
                topo, state_bytes=128 * MB, tensor_sizes=[4 * MB] * 32,
                strategy=strategy, codec=codec)
            cl.scheduler.solver_time_model = 1e-3
            cl.train(2)
            links = CS.sim_join_links(core, topo, 3, seed + 7)
            _, _, res = core.baselines.run_scale_out(cl, strategy, 1000 + seed,
                                                     links, 128 * MB)
            out.append((CS._scale_out_record(res), cl.session.idle,
                        topo.snapshot(), cl.scheduler.replication_wire_bytes,
                        cl.net.metrics_snapshot()))
    return out


@pytest.mark.parametrize("codec", ["none", "int8", "auto"])
@pytest.mark.parametrize("strategy", list(baselines.STRATEGIES))
def test_scale_out_results_match_jax(strategy, codec):
    """``ScaleOutResult`` (delay, replication, solver under a pinned
    ``solver_time_model``, idle, timeline, replans, the plan's summary and
    routes), the training idle, the topology and the network counters."""
    assert baselines.STRATEGIES == JAX.baselines.STRATEGIES
    assert _scale_outs(PORT, strategy, codec) == _scale_outs(JAX, strategy, codec)


@pytest.mark.parametrize("n, seed", [(6, 0), (8, 1), (10, 2), (12, 3)])
def test_primitive_results_match_jax(n, seed):
    """Scale-in, connect-link and disconnect-link: ``PrimitiveResult``."""
    assert CS.sim_primitives(PORT, n, seed) == CS.sim_primitives(JAX, n, seed)


def _inflight_record(fl):
    return ([(r.source, r.nbytes, r.route, r.gen, r.credited, r.credited_wire,
              r.codec, r.wire_nbytes, r.payload_shard, r.wire_shard, r.decode_s,
              r.handle.done_t, r.handle.cancelled, r.handle.cancelled_delivered)
             for r in fl.transfers],
            fl.delivered_bytes(), fl.credited_bytes(), fl.wire_delivered_bytes(),
            fl.decode_critical_s(), fl.replans, fl.aborted, fl.t_last_credit,
            dict(fl.timeline), fl.solver_s, CS._plan_record(fl.plan))


def _replan_run(core, strategy, codec, partial_credit):
    """A join whose stream is cut mid-flight: once a stream has delivered
    three wire shards (or half its bytes), the link under its last hop fails, the scheduler
    credits the delivered prefix and re-plans the rest, and the join
    finishes."""
    topo = core.topology.random_edge_topology(8, seed=0)
    cl = core.negotiation.SimCluster(topo, state_bytes=128 * MB,
                                     tensor_sizes=[2 * MB] * 64,
                                     strategy=strategy, codec=codec)
    sched = cl.scheduler
    sched.solver_time_model = 1e-3
    sched.partial_credit = partial_credit
    cl.train(1)
    L = core.topology.Link
    fl = sched.begin_scale_out(100, {1: L(400.0, 0.01), 2: L(600.0, 0.01),
                                     3: L(250.0, 0.02)},
                               128 * MB, [2 * MB] * 64)
    cl.sim.run(until=fl.t_transfers_start)
    for _ in range(400):  # until a stream is three wire shards or half in
        moving = [r for r in fl.pending() if r.handle.t_first_byte is not None
                  and r.handle.progress(cl.sim.now)
                  >= min(3 * max(r.wire_shard, 1), r.wire_nbytes // 2)]
        if moving:
            break
        cl.sim.run(until=cl.sim.now + 0.01)
    cut = moving[0].route[-2:]
    prim = sched.disconnect_link(*cut, failure=True)
    assert fl.uses_link(*cut) or not fl.pending()
    replanned = sched.replan_scale_out(fl)
    mid = _inflight_record(fl)
    cl.sim.run()
    res = sched.finish_scale_out(fl)
    return (replanned, mid, _inflight_record(fl), CS._scale_out_record(res),
            CS._primitive_record(prim), sched.replication_payload_bytes,
            sched.replication_wire_bytes)


@pytest.mark.parametrize("partial_credit", [True, False])
@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("strategy",
                         ["chaos", "chaos-even", "single-source", "multi-source"])
def test_replan_after_link_cut_matches_jax(strategy, codec, partial_credit):
    port = _replan_run(PORT, strategy, codec, partial_credit)
    assert port == _replan_run(JAX, strategy, codec, partial_credit)
    assert port[0] and port[2][5] == 1  # one replan, not an abort
    # The delivered prefix is credited, but for chaos-even's one-shard streams.
    assert (port[2][2] > 0) == (partial_credit and strategy != "chaos-even")


def _reshard_fetch_run(core, cancel):
    topo = core.topology.random_edge_topology(8, seed=2)
    cl = core.negotiation.SimCluster(topo, state_bytes=64 * MB,
                                     tensor_sizes=[2 * MB] * 32, codec="int8")
    cl.train(1)
    devs = tuple(sorted(topo.active_nodes()))
    P = core.plans.ParallelismPlan
    rp = core.plans.reshard_plan(P((1, 4), devices=devs[:4]),
                                 P((4, 1), devices=devs[:4]), topo, 64 * MB,
                                 codec="int8")
    sched = cl.scheduler
    fls = {node: sched.begin_reshard_fetch(node, plan, cl.sim.now + 0.01)
           for node, plan in sorted(rp.fetches.items())}
    if cancel:
        cl.sim.run(until=cl.sim.now + 0.3)
        for fl in fls.values():
            sched.cancel_reshard_fetch(fl)
    cl.sim.run()
    return {node: (_inflight_record(fl), sched.finish_reshard_fetch(fl))
            for node, fl in fls.items()}


@pytest.mark.parametrize("cancel", [False, True])
def test_reshard_fetches_match_jax(cancel):
    assert _reshard_fetch_run(PORT, cancel) == _reshard_fetch_run(JAX, cancel)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("detector", ["phi", "fixed"])
def test_monitor_events_match_jax(detector, seed):
    """Sweeps with a node fault, a blackholed link and 30% loss: the event
    records, detector counters, network counters and topology."""
    assert CS.sim_monitor_run(PORT, detector, seed) == \
        CS.sim_monitor_run(JAX, detector, seed)


def _monitor_traffic_run(core, detector):
    """Sweeps over a scale-out (piggybacking, iperf bursts on the wire), a
    silent scheduler, ``rebase_home``, a node fault whose give-up is
    deferred and restored, a re-join, and the give-up expiry."""
    topo = core.topology.random_edge_topology(8, seed=1)
    cl = core.negotiation.SimCluster(topo, state_bytes=64 * MB,
                                     tensor_sizes=[2 * MB] * 32)
    cl.scheduler.solver_time_model = 1e-3
    cl.train(1)
    mon = cl.scheduler.monitor
    mon.start_sweeps(seed=3, detector=detector)
    L = core.topology.Link
    res = cl.scale_out(100, {1: L(400.0, 0.01), 4: L(250.0, 0.02)})
    cl.sim.run(until=cl.sim.now + 10.0)
    mon.scheduler_silent = True
    mon.inject_node_fault(6)
    mon.defer_node_giveup(6)
    cl.sim.run(until=cl.sim.now + 5.0)
    cl.scheduler.handover(5)
    mon.restore_node_giveup(6)
    horizon = mon.detection_horizon()
    cl.sim.run(until=cl.sim.now + 20.0)
    mon.register_leave(100)
    mon.register_join(100, {2: L(500.0, 0.005)})
    mon.activate(100)
    mon.inject_link_loss(2, 100, 0.05)
    cl.sim.run(until=cl.sim.now + 20.0)
    expired = mon.expire_faults(cl.sim.now + 1e4)
    mon.stop_sweeps()
    return ([(e.t, e.kind, e.subject, e.detail) for e in mon.events],
            CS._scale_out_record(res), horizon, expired, mon.drain_step_s(),
            mon.faulted_nodes(), mon.faulted_links(), mon.metrics_snapshot(),
            cl.net.metrics_snapshot(), cl.scheduler.control_state(),
            list(topo.g.edges), list(topo.g))


@pytest.mark.parametrize("detector", ["phi", "fixed"])
def test_monitor_with_traffic_and_handover_matches_jax(detector):
    port = _monitor_traffic_run(PORT, detector)
    assert port == _monitor_traffic_run(JAX, detector)
    assert port[7]["piggybacked_probes"] + port[7]["piggybacked_heartbeats"] > 0


def _plans(core, strategy, codec):
    out = []
    pod = core.topology.pod_topology(32)
    sizes = CS.sim_tensor_sizes(468 * MB, 4 * MB)
    for new in (0, 5, 16, 31):
        sync = {u: 1e-3 * (u % 5) for u in pod.neighbors(new)}
        plan = core.plans.build_plan(strategy, pod, new, 468 * MB, sizes, sync,
                                     codec=codec)
        out.append((CS._plan_record(plan), plan.predicted_delay_s,
                    plan.total_wire_bytes()))
    for n, seed in ((6, 0), (9, 1), (12, 2)):
        topo = core.topology.random_edge_topology(n, seed=seed)
        topo.add_node(100)
        for p, link in CS.sim_join_links(core, topo, 3, seed).items():
            topo.add_link(p, 100, link)
        topo.nodes[100].state = "standby"
        plan = core.plans.build_plan(strategy, topo, 100, 128 * MB,
                                     [4 * MB] * 32, codec=codec)
        out.append((CS._plan_record(plan), plan.predicted_delay_s,
                    plan.total_wire_bytes(),
                    [(u, plan.wire_shard_for(u)) for u in plan.sources]))
    return out


@pytest.mark.parametrize("codec", ["none", "int8", "auto"])
@pytest.mark.parametrize("strategy", sorted(plans.STRATEGY_BUILDERS))
def test_build_plan_matches_jax(strategy, codec):
    assert sorted(plans.STRATEGY_BUILDERS) == sorted(JAX.plans.STRATEGY_BUILDERS)
    assert _plans(PORT, strategy, codec) == _plans(JAX, strategy, codec)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_reshard_plan_over_the_ports_topology_matches_jax(codec):
    """The port's ``reshard_plan`` over the port's ``Topology`` against the
    JAX function over the JAX ``Topology``: fetches, bytes and routes (a
    link removed so that some fetches route over two hops)."""
    out = []
    for core in BOTH:
        topo = core.topology.random_edge_topology(10, seed=4)
        topo.remove_link(*next(iter(topo.g.edges)))
        devs = tuple(sorted(topo.active_nodes()))[:8]
        P = core.plans.ParallelismPlan
        rows = []
        for old, new in [(None, (2, 4)), ((2, 4), (4, 2)), ((4, 2), (1, 8))]:
            rp = core.plans.reshard_plan(P(old, devices=devs) if old else None,
                                         P(new, devices=devs), topo,
                                         64 * MB + 12, codec=codec)
            rows.append((rp.moved_bytes, rp.lost_bytes,
                         {node: CS._plan_record(f)
                          for node, f in sorted(rp.fetches.items())}))
        out.append(rows)
    assert out[0] == out[1]
    assert any(len(r) > 2 for rows in out[1] for fetch in rows[2].values()
               for r in fetch["routes"].values())


def test_sharding_alg_baselines_match_jax():
    """``even_assignment``, ``brute_force_assignment``, ``_compositions``,
    ``ragged_shards``, ``greedy_ragged_assignment``, ``brute_force_ragged``
    and the lazy re-export of the plan builders."""
    rng = random.Random(11)
    for trial in range(6):
        nbs = []
        for mod in (JAX.sharding_alg, sharding_alg):
            r = random.Random(trial)
            nbs.append({u: mod.NeighborLink(r.uniform(0.001, 0.02),
                                            1 / (r.uniform(100, 1000) * 125000),
                                            r.uniform(0.0, 0.05))
                        for u in r.sample(range(10), 3)})
        sizes = [rng.choice((MB, 3 * MB, 4 * MB + 17)) for _ in range(5)]
        got = []
        for mod, nb in zip((JAX.sharding_alg, sharding_alg), nbs):
            shards = mod.ragged_shards(sizes, 2 * MB)
            got.append((
                dataclasses.asdict(mod.even_assignment(11, 4 * MB, nb)),
                dataclasses.asdict(mod.brute_force_assignment(9, 4 * MB, nb)),
                list(mod._compositions(5, 3)), shards,
                mod.greedy_ragged_assignment(shards, nb),
                mod.greedy_ragged_assignment(shards, nb, sort_desc=False),
                mod.brute_force_ragged(shards[:7], nb)))
        assert got[0] == got[1]
    assert sharding_alg._PLAN_EXPORTS == JAX.sharding_alg._PLAN_EXPORTS
    for name in sharding_alg._PLAN_EXPORTS:
        assert getattr(sharding_alg, name) is getattr(plans, name)
    with pytest.raises(AttributeError):
        sharding_alg.no_such_name


def test_link_objects_match_jax():
    d = {"t": 1.0, "kind": "join", "node": 9,
         "links": {"1": [400.0, 0.01], "3": [250.0, 0.02]}}
    got = engine.ChurnEvent.from_json(d).link_objects()
    want = JAX.engine.ChurnEvent.from_json(d).link_objects()
    assert {p: dataclasses.asdict(l) for p, l in got.items()} == \
        {p: dataclasses.asdict(l) for p, l in want.items()}
    assert all(isinstance(l, topology.Link) for l in got.values())
    assert engine.ChurnEvent(t=0.0, kind="leave", node=1).link_objects() == {}


# -- chip_smoke.py's simulator phase, on the CPU ---------------------------------


def test_simulator_digest_is_pinned_to_the_jax_package():
    """The JAX package's sweep gives ``chip_smoke.SIMULATOR_DIGEST``: change
    the sweep and this prints the digest to pin."""
    digest = CS.sweep_digest(CS.simulator_sweep(repro.core))
    if digest != CS.SIMULATOR_DIGEST:
        print(f"SIMULATOR_DIGEST = {digest!r}")
    assert digest == CS.SIMULATOR_DIGEST


def test_port_reproduces_the_simulator_digest():
    import repro_torch.core

    assert CS.sweep_digest(CS.simulator_sweep(repro_torch.core)) == \
        CS.SIMULATOR_DIGEST
