"""Quick-tier regression test for loop-candidate index resolution.

Round-4 soak crash: ``detect_candidate`` resolved the winning old keyframe
back to a position in ``tracker.keyframes`` with ``list.index``, which runs
the ``Keyframe`` dataclass ``__eq__`` — an elementwise ndarray comparison —
against every earlier entry and raises ``ValueError: truth value of an
array ... is ambiguous`` whenever the winner is not the first keyframe.
The fix resolves by object identity. Reference semantics: ORB-SLAM2's
LoopClosing::DetectLoop returns KeyFrame pointers, i.e. identity
(/root/reference/thirdparty/orb-slam2/src/LoopClosing.cc).
"""

import numpy as np

from pilotguru.vo.loopclosing import detect_candidate
from pilotguru.vo.tracking import Keyframe, TrackerConfig


class _StubTracker:
    """Just the surface detect_candidate touches: config, keyframes, and
    per-keyframe device descriptor copies."""

    def __init__(self, keyframes, config):
        self.keyframes = keyframes
        self.config = config

    def kf_descriptors_device(self, kf):
        import jax.numpy as jnp

        return jnp.asarray(kf.descriptors), jnp.asarray(kf.kp_valid)


def _keyframe(kf_id, descriptors):
    k = descriptors.shape[0]
    return Keyframe(
        pose6=np.zeros(6),
        kp_norm=np.zeros((k, 2)),
        descriptors=descriptors,
        kp_valid=np.ones(k, bool),
        map_point=np.full(k, -1, np.int32),
        kf_id=kf_id,
    )


def test_candidate_index_resolved_by_identity_not_dataclass_eq():
    rng = np.random.default_rng(7)
    k = 64
    rand = lambda: rng.integers(0, 2, size=(k, 256)).astype(np.uint8)
    revisit_desc = rand()
    # keyframes[1] is the revisited place; keyframes[0] and [2] are noise.
    # The winner being a NON-first entry is what made list.index blow up.
    keyframes = [
        _keyframe(0, rand()),
        _keyframe(1, revisit_desc),
        _keyframe(2, rand()),
    ]
    tracker = _StubTracker(
        keyframes,
        TrackerConfig(loop_exclude_recent=1, loop_min_match_count=10),
    )
    current = _keyframe(99, revisit_desc.copy())

    idx = detect_candidate(tracker, current)

    assert idx == 1


def test_candidate_culled_between_sweep_and_consume_returns_none_or_valid():
    """A winner culled after the vote sweep must not crash or mis-index."""
    rng = np.random.default_rng(8)
    k = 64
    rand = lambda: rng.integers(0, 2, size=(k, 256)).astype(np.uint8)
    revisit_desc = rand()
    keyframes = [_keyframe(0, rand()), _keyframe(1, revisit_desc)]
    tracker = _StubTracker(
        keyframes,
        TrackerConfig(loop_exclude_recent=0, loop_min_match_count=10),
    )
    current = _keyframe(99, revisit_desc.copy())

    from pilotguru.vo.loopclosing import start_vote_sweep

    handle = start_vote_sweep(tracker, current)
    # Cull the winner before the handle is consumed (kf_id-keyed drop path).
    tracker.keyframes = [keyframes[0]]
    idx = detect_candidate(tracker, current, vote_handle=handle)

    assert idx is None
