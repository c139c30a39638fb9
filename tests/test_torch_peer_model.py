"""The protocol of csrc/ring_peer.cu (the cross-rank gather,
reduce-scatter and all-reduce on peer buffers) in its host model,
parallel/peer_model.py, under interleavings drawn from seeded numpy
generators: 2, 3 and 4 ranks, 60 calls each of eager calls mixed with
replayed graphs, each kernel of 1 to 3 blocks. No rank reads data before
its owner wrote it for the call, none overwrites data before every reader
read it, no schedule deadlocks, and every rank's device call count ends at
its number of calls. The model's checks are shown to catch the faults the
redesign removed: a host sequence number under replays, and a grid that
does not fit beside its peers' on the card."""

import numpy as np
import pytest

from avatarcraft_tpu_torch.parallel import peer_model as pm

CALLS = 60


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("seed", range(4))
def test_protocol_holds_under_random_interleavings(n, seed):
    rng = np.random.default_rng(1000 * n + seed)
    calls = pm.schedule(rng, CALLS)
    assert len(calls) >= CALLS and {kind for kind, _ in calls} == set(pm.OPS)
    # unbounded residency, and a card that holds exactly every rank's largest grid
    assert pm.run(n, calls, rng) > 0
    assert pm.run(n, calls, rng, grids=[3] * n, slots=3 * n) > 0


def test_a_host_sequence_number_breaks_under_replays():
    """Before the redesign the host passed each call's sequence number: a
    replayed graph passes its capture's number again, and the flags pass
    stale data."""
    caught = 0
    for seed in range(8):
        rng = np.random.default_rng(seed)
        try:
            pm.run(2, pm.schedule(rng, 30), rng, host_seq=True)
        except pm.ProtocolError:
            caught += 1
    assert caught > 0


def test_a_grid_larger_than_its_share_of_the_card_deadlocks():
    """Two ranks whose kernels of 2 blocks share a card that holds 2: one
    rank's grid can fill it while it waits for the other's."""
    deadlocks = 0
    for seed in range(8):
        rng = np.random.default_rng(seed)
        try:
            pm.run(2, [("all_reduce", None)] * 4, rng, grids=[2, 2], slots=2)
        except pm.Deadlock:
            deadlocks += 1
    assert deadlocks > 0
    rng = np.random.default_rng(0)
    pm.run(2, [("all_reduce", None)] * 4, rng, grids=[1, 1], slots=2)  # sized to its share: no deadlock
