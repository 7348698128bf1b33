"""Production-shape sharding validation on the 8-device CPU mesh.

VERDICT r4 #5: the multichip dryrun proved the mesh/TP/PPO plumbing only
at toy shapes (2 robots, 64 beams).  This exercises the bench-class
parity-sensor program — 8 scenes x 8 robots, 400x400 views, 960-beam
lasers, TWO sensor groups, SFM leg crowd — through the flat multi-scene
sensor pass, sharded over all 8 virtual devices (conftest forces the
8-device CPU mesh).  The same XLA sensor path runs on every platform;
chip_smoke.py checks the GPU against the CPU at production shape.
"""

import pytest

pytestmark = pytest.mark.slow     # ~80 s cold compile on the CPU mesh


def test_production_shape_dryrun(capsys):
    from __graft_entry__ import dryrun_production_shape

    dryrun_production_shape(8)
    out = capsys.readouterr().out
    assert "dryrun_production_shape ok" in out
    assert "sharded over 8 devices" in out
