"""The general generator: turns a traffic mix's parameters and a seed into
the events a run replays.

A mix is a closed loop: the events fall between steps. The window is a
sequence of slots, each ``steps_per_slot`` steps on the current membership
followed by one event (or none). ``cycle`` fixes the slots' pattern, one
letter a slot: ``J`` a join, ``D`` a departure, ``X`` a link event, ``S``
steps only. The ``X`` slots take ``link_events`` in order, one cycle's
worth (each a ``ChurnEvent``'s fields: ``kind``, ``u``, ``v``, a
degrade's ``bandwidth_mbps``). The pattern, and so the membership and the
links at every step, is the same for every seed, because they set what a
join plans and how many shards a push cuts; the seed orders the
departures' kinds (``departures``: counts per kind over one cycle, all
costing the trainer the same). So every seed does the same work, in
another order. A ``checkpoint`` event (a push to the replica tier) follows
every ``checkpoint_every_steps`` steps.

Set-up visits every membership the window does, one step at each, before
the window starts from ``initial`` (``setup_slots``).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, List, Optional

#: the cycle's letters and the membership change each makes.
LETTERS = {"J": 1, "D": -1, "X": 0, "S": 0}
DEPARTURES = ("leave", "node-failure")
LINK_EVENTS = ("link-degrade", "link-join")
#: first trace node id the generator hands out; every join and departure
#: names a fresh node, so a replayed trace never reuses a departed one.
FIRST_NODE = 1000


@dataclass(frozen=True)
class Slot:
    """``steps`` training steps, then ``event`` (a ``ChurnEvent``'s
    fields, or None)."""
    steps: int
    event: Optional[dict]


def cycle_letters(mix: dict) -> str:
    return "".join(mix["cycle"].split())


def check_mix(mix: dict) -> None:
    """Raise unless the cycle keeps the membership inside ``[min_active,
    max_active]``, ends where it starts and names as many departures and
    link events as its counts give."""
    letters = cycle_letters(mix)
    if not letters or set(letters) - set(LETTERS):
        raise ValueError(f"cycle {mix['cycle']!r}: letters are {sorted(LETTERS)}")
    n = mix["initial"]
    for c in letters:
        n += LETTERS[c]
        if not mix["min_active"] <= n <= mix["max_active"]:
            raise ValueError(f"cycle {mix['cycle']!r} leaves [{mix['min_active']}, "
                             f"{mix['max_active']}] active")
    if n != mix["initial"]:
        raise ValueError(f"cycle {mix['cycle']!r} does not return to {mix['initial']}")
    counts = mix.get("departures", {})
    if set(counts) - set(DEPARTURES) or sum(counts.values()) != letters.count("D"):
        raise ValueError(f"departures {counts}: {letters.count('D')} of {DEPARTURES} a cycle")
    links = mix.get("link_events", [])
    if len(links) != letters.count("X") or any(e["kind"] not in LINK_EVENTS for e in links):
        raise ValueError(f"link_events: {letters.count('X')} of {LINK_EVENTS} a cycle")


def link_seconds(mix: dict, device_id: int):
    """(propagation s, transmission s per byte, sync s) of a device's link:
    the mix's ``links`` for even and odd device ids."""
    link = mix["links"]["even" if device_id % 2 == 0 else "odd"]
    return (link["latency_s"], 1 / (link["mbps"] * 1e6 / 8), 0.0)


def _kinds(rng: random.Random, counts: dict) -> List[str]:
    kinds = [k for k in sorted(counts) for _ in range(counts[k])]
    rng.shuffle(kinds)
    return kinds


def slots(mix: dict, seed: int) -> Iterator[Slot]:
    """The window's slots, without end."""
    check_mix(mix)
    rng = random.Random(seed)
    letters = cycle_letters(mix)
    per_slot = mix["steps_per_slot"]
    every = mix.get("checkpoint_every_steps", 0)
    node = FIRST_NODE
    steps = 0
    while True:
        departures = _kinds(rng, mix.get("departures", {}))
        links = iter(mix.get("link_events", []))
        for c in letters:
            event = None
            if c in "JD":
                event = {"kind": "join" if c == "J" else departures.pop(), "node": node}
                node += 1
            elif c == "X":
                event = dict(next(links))
            yield Slot(per_slot, event)
            for _ in range(per_slot):
                steps += 1
                if every and steps % every == 0:
                    yield Slot(0, {"kind": "checkpoint"})


def setup_slots(mix: dict) -> List[Slot]:
    """Set-up: three steps, the first on ``initial`` devices; where the
    cycle joins, a join after each of the first two steps (so that the
    steps run on every membership up to ``max_active`` where that is
    ``initial + 2``); a push after the third where the mix pushes; then
    departures back to ``initial``. Nodes are numbered below
    ``FIRST_NODE``."""
    check_mix(mix)
    letters = cycle_letters(mix)
    if "J" not in letters:
        out = [Slot(3, None)]
    else:
        ups = min(2, mix["max_active"] - mix["initial"])
        out = [Slot(1, {"kind": "join", "node": FIRST_NODE - 1 - i}) for i in range(ups)]
        out.append(Slot(3 - ups, None))
    if mix.get("checkpoint_every_steps", 0):
        out.append(Slot(0, {"kind": "checkpoint"}))
    joined = sum(1 for s in out if s.event and s.event["kind"] == "join")
    out += [Slot(0, {"kind": "leave", "node": FIRST_NODE - 100 - i})
            for i in range(joined)]
    return out


def setup_rows(mix: dict) -> List[int]:
    """The global batch of each set-up step, following ``setup_slots``'
    joins and departures."""
    n, rows = mix["initial"], []
    for slot in setup_slots(mix):
        rows += [n * mix["per_device_batch"]] * slot.steps
        if slot.event and slot.event["kind"] == "join":
            n += 1
        elif slot.event and slot.event["kind"] in DEPARTURES:
            n -= 1
    return rows
