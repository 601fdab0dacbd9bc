"""The center's SIGKILL in an elastic run of the port, on the CPU: the
counterpart of ``tests/test_chaos.py``'s
``test_elastic_center_sigkill_recovers_without_world_restart``.

``run_elastic(..., center_proc=True)`` runs the center as a supervised
process of its own (``center_main``: a fixed port, snapshots, a lease),
with a ``net_dup`` window duplicating every frame between the islands
and the center (the chaos proxy).  The center is SIGKILLed mid-run; the
supervisor emits ``center_down``, respawns it from its snapshot on the
same port and emits ``center_restored`` once it answers; the islands
ride the gap out on the wire's retries.  No island is restarted, every
duplicated push is applied once, and the islands' exchange rounds join
the center's server spans (``tracing=true``).
"""

import json
import os
import sys

from theanompi_tpu_torch.parallel import membership as mb
from theanompi_tpu_torch.utils import chaos

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_elastic import MODEL, island_env, merged_events  # noqa
from test_torch_elastic import SUPERVISOR  # noqa: E402


def test_elastic_center_sigkill_recovers_without_world_restart(tmp_path,
                                                               island_env):
    record_dir = str(tmp_path)
    schedule = chaos.parse_schedule("kill@10:0")       # worker 0: the center
    net_schedule = chaos.parse_schedule("net_dup@0:-1:600")
    # ≥ 80 · 0.2 = 16 s of training after the gate: the t=10 kill lands
    # mid-run, and an island blocked in an exchange's retries rides out
    # the respawn
    rc = mb.run_elastic(
        "easgd", *MODEL,
        {"sync_freq": 2, "iter_sleep": 0.2, "tracing": True,
         "wire_timeout": 5, "wire_deadline": 90,
         "center_snapshot_every_s": 0.5}, 2,
        record_dir=record_dir, steps=80, host_devices=1,
        chaos_schedule=schedule, net_chaos_schedule=net_schedule,
        center_proc=True, timeout_s=420,
        supervisor_kw=dict(SUPERVISOR, backoff=mb.Backoff(base=0.3),
                           lease_timeout=120.0))
    assert rc == 0
    assert schedule[0].error is None, "the center kill never landed"
    events = merged_events(record_dir)
    downs = [e for e in events if e["ev"] == "center_down"]
    restores = [e for e in events if e["ev"] == "center_restored"]
    assert downs and downs[-1]["rc"] == -9, downs
    assert restores, "the center was never restored"
    assert restores[-1]["ts"] > downs[-1]["ts"], "the run ended center-down"
    for w in (1, 2):
        joins = [e for e in events if e["ev"] == "worker_join"
                 and e.get("worker") == w]
        finishes = [e for e in events if e["ev"] == "worker_leave"
                    and e.get("worker") == w
                    and e.get("reason") == "finished"]
        assert len(joins) == 1, (w, joins)
        assert finishes, (w, "did not finish cleanly")
    with open(os.path.join(record_dir, "center_stats.json")) as f:
        stats = json.load(f)
    assert stats["dedup_hits"] > 0, stats
    assert stats["n_updates"] == sum(stats["by_island"].values())
    assert stats["center_downs"] >= 1
    assert stats["net_frames_faulted"]["net_dup"] > 0
    assert os.path.exists(os.path.join(record_dir, "center_final.npz"))
    # the center's own lease: beaten by each life, released by the last
    docs = mb.read_leases(os.path.join(record_dir, "membership", "center"))
    assert docs[0]["status"] == "left"
    # the islands' rounds joined the center's spans through the kill
    spans = [e for e in events if e["ev"] == "span"]
    servers = {e["parent"] for e in spans if e.get("side") == "server"}
    wire = [e for e in spans if e["name"] == "wire.push"
            and e.get("ok")]
    assert wire and sum(e["span"] in servers for e in wire) >= \
        0.9 * len(wire), (len(wire), len(servers))
    assert {e.get("role") for e in events if e["ev"] == "statusz"} >= \
        {"worker", "supervisor", "center"}
