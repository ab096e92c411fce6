"""The krylov_graph_share reader on hand-made diagnostics."""

import numpy as np

from nsbench import harness


def _ctx(diags, on_card=True):
    ctx = harness.Context(on_card)
    ctx.diags = diags
    return ctx


def test_replays_over_the_lockstep_iterations():
    r = harness.load_reader("krylov_graph_share")
    # two sweep steps: lockstep maxima 3 + 5 and 4 + 6; 5 and 6 replayed
    diags = [
        dict(iters_f=np.array([3, 2]), iters_s=np.array([5, 4]), graphed_s=np.array([5, 5])),
        dict(iters_f=np.array([4, 4]), iters_s=np.array([6, 1]), graphed_s=np.array([6, 6])),
    ]
    assert abs(r.read(_ctx(diags)) - 100.0 * 11 / 18) < 1e-12
    eager = [dict(d, graphed_s=np.zeros(2, np.int64)) for d in diags]
    assert r.read(_ctx(eager)) == 0.0


def test_a_program_without_the_counter_or_off_the_card_reads_nothing():
    r = harness.load_reader("krylov_graph_share")
    assert r.read(_ctx([dict(iters_f=np.array([3]), iters_s=np.array([5]), graphed_s=np.array([0]))], False)) is None
    assert r.read(_ctx([dict(iters_f=np.array([3]), iters_s=np.array([5]))])) is None
    assert r.read(_ctx([])) is None
    assert r.read(_ctx([dict(iters_f=np.array([0]), iters_s=np.array([0]), graphed_s=np.array([0]))])) is None
