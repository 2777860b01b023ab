"""The benchmark's readers of the fleet round's structure
(``twbench/metrics/lead_s.py``, ``tail_s.py``, ``decode_wall_s.py``): each
loads through ``twbench.spec.reader``, reads the mean of its stats key over
a reading's rounds, and reads None when no round holds the key (a program
that records none)."""

import pytest

from twbench import spec

#: metric name -> the ``solve_fleet`` stats key it reads
KEYS = {"lead_s": "fleet_lead_s", "tail_s": "fleet_tail_s",
        "decode_wall_s": "decode_wall_s"}


def _reading(*stats):
    return {"rounds": [{"wall": 0.8, "stats": s, "quarantined": 0} for s in stats]}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_reads_the_mean_over_rounds(name):
    key = KEYS[name]
    read = spec.reader(name)
    got = read(_reading({key: 0.25, "decode_s": 0.4}, {key: 0.5, "decode_s": 0.4}))
    assert got == pytest.approx(0.375)


@pytest.mark.parametrize("name", sorted(KEYS))
def test_none_without_the_key(name):
    read = spec.reader(name)
    assert read(_reading({"decode_s": 0.4, "pack_s": 0.1}, {"decode_s": 0.3})) is None


def test_declared_in_the_benchmark():
    per_layer = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in KEYS:
        m = per_layer[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "s/round", "lower", "program_span", "spans_per_s")
    assert per_layer["lead_s"]["layer"] == per_layer["tail_s"]["layer"] == "fleet round"
    assert per_layer["decode_wall_s"]["layer"] == per_layer["decode_s"]["layer"]
