"""The one traffic generator: the same seed gives the same frames and
slices, another seed others, with the same sizes; malformed mixes are
refused."""

import itertools
import json

import numpy as np
import pytest

from benchmark import harness, traffic

MIX = f"{harness.ROOT}/benchmark/traffic/offline-480p.json"


def _mix(**small):
    t = traffic.load(MIX)
    t.update(small)
    return t


def test_same_seed_same_frames_and_slices():
    t = _mix(height=6, width=10, pool_frames=12)
    seed = 2**31 + 77
    a, b, c = (traffic.make_pool(t, s, "cpu") for s in (seed, seed, seed + 1))
    assert a.shape == (12, 6, 10) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    sa, sb, sc = (list(itertools.islice(traffic.slices(t, s), 40)) for s in (seed, seed, seed + 1))
    assert sa == sb and sa != sc
    assert {n for _, n in sa} == {n for _, n in sc} == {t["batch_frames"]}  # the same work
    assert all(0 <= s <= t["pool_frames"] - n for s, n in sa)


def test_pool_is_made_in_chunks(monkeypatch):
    monkeypatch.setattr(traffic, "POOL_CHUNK_BYTES", 6 * 10 * 5)
    whole = traffic.make_pool(_mix(height=6, width=10, pool_frames=12), 5, "cpu")
    assert whole.shape[0] == 12 and len({whole[i].tobytes() for i in range(12)}) == 12


@pytest.mark.parametrize("bad", [{"height": 0}, {"check_frames": "4"}, {"host_threads": 0},
                                 {"batch_frames": 33}, {"depth": None}])
def test_malformed_mixes_are_refused(tmp_path, bad):
    t = json.load(open(MIX))
    t.update(bad)
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(t))
    with pytest.raises(ValueError):
        traffic.load(str(path))
