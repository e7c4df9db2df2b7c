"""The port's autoscaler (``autoscale.py``) against the reference's on the
CPU: ``read_signals`` on the same health bodies (the two packages' own
controllers' ``health_json`` among them), ``Autoscaler.decide`` and
``apply`` over one seeded sequence of signals with an injected clock (the
same decisions, counters and exported families), a ``ThreadFleetDriver``
of the port's agents over the port's ``LoopbackSession`` that scales up
under load and retires members by drain, and a ``ProcessFleetDriver`` that
spawns ``python -m agent_tpu_torch.agent.fleet`` children on the CPU and
retires them by SIGTERM, each exiting 0; a member SIGTERMed while it
warms exits 0 without leasing (a difference the port keeps). Every
comparison is exact."""

import random
import threading
import time

import pytest

import agent_tpu.autoscale as ref_scale
import agent_tpu.config as ref_config
import agent_tpu_torch.autoscale as port_scale
import agent_tpu_torch.config as port_config
from agent_tpu.controller.core import Controller as RefController
from agent_tpu_torch.controller.core import Controller

SIDES = {"port": (port_scale, port_config, Controller),
         "ref": (ref_scale, ref_config, RefController)}
DEADLINE_S = 90.0


def _health_bodies():
    rng = random.Random(5)
    bodies = [None, {}, "not a dict", {"verdict": "page"}]
    for _ in range(40):
        agents = {}
        for i in range(rng.randrange(4)):
            row = {"duty_cycle": rng.choice([None, rng.random()]), "stale": rng.random() < 0.2,
                   "draining": rng.random() < 0.2}
            agents[f"a{i}"] = row
        bodies.append({
            "verdict": rng.choice(["ok", "warn", "page"]),
            "queue": {"depth": rng.randrange(20),
                      "starvation_age_sec": rng.choice([None, rng.random() * 30])},
            "slo": {"objectives": [{"state": rng.choice(["ok", "warn", "page"])}
                                   for _ in range(rng.randrange(3))]},
            "agents": agents,
            "counts": {"pending": rng.randrange(5), "leased": rng.randrange(3)},
        })
    return bodies


@pytest.mark.parametrize("i", range(44))
def test_read_signals_matches_the_reference(i):
    body = _health_bodies()[i]
    assert port_scale.read_signals(body).__dict__ == ref_scale.read_signals(body).__dict__


def test_read_signals_of_each_controllers_health_is_alike():
    got = {}
    for side, (scale, config, ctrl_cls) in SIDES.items():
        c = ctrl_cls(flow=config.FlowConfig(cache_enabled=False))
        for i in range(6):
            c.submit("echo", {"i": i})
        c.lease("a1", capabilities={"ops": ["echo"]}, max_tasks=2,
                metrics={"obs": {}}, draining=False)
        got[side] = dict(scale.read_signals(c.health_json()).__dict__)
        c.close()
    ages = [got[side].pop("starvation_age_sec") for side in SIDES]  # wall-clock ages
    assert got["port"] == got["ref"] and all(isinstance(a, float) for a in ages)


class FakeDriver:
    """Members that come and go at once; ``lost`` members vanish (a
    reclaim) so the repair path runs."""

    def __init__(self):
        self.n = 1

    def size(self):
        return self.n

    def spawn(self, n):
        self.n += n
        return [f"m{i}" for i in range(n)]

    def retire(self, n):
        n = min(n, self.n)
        self.n -= n
        return [f"m{i}" for i in range(n)]


def _decisions(side, seed):
    scale, config, _ = SIDES[side]
    rng = random.Random(seed)
    clock = {"t": 100.0}
    driver = FakeDriver()
    scaler = scale.Autoscaler(driver, lambda: None, config=config.AutoscaleConfig(
        min_agents=1, max_agents=4, up_queue_per_agent=2.0, down_idle_evals=2,
        up_cooldown_sec=1.5, down_cooldown_sec=2.0, step_up=2), clock=lambda: clock["t"])
    out = []
    for _ in range(200):
        clock["t"] += rng.choice([0.25, 0.5, 1.0])
        if rng.random() < 0.05 and driver.n > 1:
            driver.n -= 1  # a member lost
        sig = scale.Signals(queue_depth=rng.choice([0, 0, 0, 1, 3, 9, 20]),
                            starvation_age_sec=rng.choice([None, 2.0, 15.0]),
                            slo_burning=rng.random() < 0.1, live_agents=driver.n,
                            max_duty=rng.choice([None, 0.05, 0.5]),
                            active_jobs=rng.choice([0, 0, 2]), healthy=rng.random() > 0.05)
        d = scaler.decide(sig)
        scaler.apply(d)
        out.append((d.action, d.n, d.reason, driver.n, scaler.desired))
    out.append((scaler.scale_ups, scaler.scale_downs, scaler.replacements))
    out.append(scaler.metrics.render() if hasattr(scaler.metrics, "render") else None)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decisions_match_the_reference(seed):
    port, ref = _decisions("port", seed), _decisions("ref", seed)
    assert port == ref
    actions = {step[0] for step in port[:-2]}
    assert {"up", "down", "hold"} <= actions, actions


def test_a_thread_fleet_of_port_agents_scales_up_and_retires_by_drain():
    """The reference's end-to-end round with the port's classes: queue
    pressure grows the fleet, the idle tail shrinks it back through the
    drain path, every job succeeds once."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.chaos import LoopbackSession
    from agent_tpu_torch.config import AgentConfig, Config

    controller = Controller(lease_ttl_sec=5.0, sweep_interval_sec=0.1)

    class Throttled:
        """A loopback with a transport round trip, so queue pressure shows."""

        def __init__(self, inner):
            self.inner = inner

        def post(self, url, json=None, timeout=None):  # noqa: A002
            time.sleep(0.02)
            return self.inner.post(url, json=json, timeout=timeout)

    def factory(name):
        agent = Agent(Config(agent=AgentConfig(
            controller_url="http://loopback", agent_name=name, tasks=("echo",), max_tasks=1,
            idle_sleep_sec=0.01, error_backoff_sec=0.01, pipeline_depth=0)),
            session=Throttled(LoopbackSession(controller)))
        agent._profile = {}
        return agent

    driver = port_scale.ThreadFleetDriver(factory, name_prefix="e2e")
    scaler = port_scale.Autoscaler(driver, controller.health_json, config=port_config.
                                   AutoscaleConfig(min_agents=1, max_agents=3,
                                                   interval_sec=0.1, up_queue_per_agent=2.0,
                                                   down_idle_evals=2, down_max_duty=1.0,
                                                   up_cooldown_sec=0.3,
                                                   down_cooldown_sec=0.2),
                                   registry=controller.metrics)
    stop = threading.Event()
    thread = threading.Thread(target=scaler.run, args=(stop,), kwargs={"interval_sec": 0.1},
                              daemon=True)
    try:
        driver.spawn(1)
        thread.start()
        for i in range(40):
            controller.submit("echo", {"i": i})
        deadline = time.monotonic() + 30.0
        while not controller.drained() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert controller.drained() and scaler.scale_ups >= 1
        deadline = time.monotonic() + 15.0
        while driver.size() > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert driver.size() == 1 and scaler.scale_downs >= 1
    finally:
        stop.set()
        thread.join(timeout=5)
        driver.retire(driver.size())
        controller.close()
    assert controller.counts() == {"succeeded": 40}
    assert scaler.replacements == 0
    for entry in driver.retired:
        assert entry["clean_exit"] and entry["spool_len"] == 0
        assert controller.agents_summary()[entry["name"]]["draining"]


def test_a_process_fleet_spawns_port_members_and_retires_them_with_exit_0():
    from agent_tpu_torch.controller import ControllerServer

    c = Controller(flow=port_config.FlowConfig(cache_enabled=False))
    with ControllerServer(c) as srv:
        driver = port_scale.ProcessFleetDriver(
            srv.url, "echo", max_agents=2, platform="cpu", name_prefix="proc",
            extra_env={"IDLE_SLEEP_SEC": "0.02", "JAX_PLATFORMS": "cpu"})
        try:
            names = driver.spawn(3)  # two slots: the third finds none
            assert len(names) == 2 and driver.size() == 2
            for i in range(6):
                c.submit("echo", {"i": i})
            deadline = time.monotonic() + DEADLINE_S
            while not (c.drained() and set(names) <= set(c.agents_summary())):
                assert time.monotonic() < deadline, "the members did not drain the jobs"
                assert driver.size() == 2, "a member exited early"
                time.sleep(0.05)
            assert sorted(driver.retire(2)) == sorted(names)
            while len(driver.retired) < 2:
                assert time.monotonic() < deadline, "a member did not exit after SIGTERM"
                driver.reap()
                time.sleep(0.05)
        finally:
            driver.stop_all(timeout=10)
    assert c.counts() == {"succeeded": 6}
    assert sorted(driver.retired) == sorted(names)
    assert all(driver.history[n]["rc"] == 0 for n in names), driver.history
    assert all(driver.history[n]["exited"] >= driver.history[n]["retired"]
               >= driver.history[n]["spawned"] for n in names)


@pytest.mark.parametrize("signalled", [True, False])
def test_a_member_retired_while_warming_exits_0_without_leasing(signalled, monkeypatch,
                                                                tmp_path):
    """A port difference: the autoscaler's SIGTERM to a member still warming
    up lets the warm-up finish, then the member exits 0 without starting
    its agent loop; unsignalled, the loop runs with the default SIGTERM
    action until the agent installs its drain."""
    import os
    import signal

    from agent_tpu_torch.agent import app, fleet

    warm = tmp_path / "warm.json"
    warm.write_text("[]")
    monkeypatch.setenv("AGENT_WARM_FILE", str(warm))
    monkeypatch.setattr(fleet, "warm_from_file", lambda path: os.kill(
        os.getpid(), signal.SIGTERM) if signalled else 0)
    ran = []
    monkeypatch.setattr(app, "main", lambda: ran.append(signal.getsignal(signal.SIGTERM)) or 7)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        rc = fleet.child_main()
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert (rc, ran) == ((0, []) if signalled else (7, [signal.SIG_DFL]))
