"""The protocol of the ring halo exchange (kernel K13,
``savgol_tpu_torch/csrc/halo_ring.cu``), checked on the CPU with no card and
no build: a model of each rank's stream and an exhaustive search of how the
ranks' steps interleave.

Each rank runs its exchanges 1, 2, ... in stream order, and exchange e is,
in order: the two stores of ``halo_send`` (tail into the right neighbour's
LEFT slot, head into the left neighbour's RIGHT slot, both of parity
e % kParities), the two signals (e into the right neighbour's LEFT arrival
word and into the left neighbour's RIGHT word), the two waits (each of the
rank's own words against e by kWaitRule), and the two reads of
``halo_recv`` (its own slots of that parity). Any step of any rank may come
next, as long as its stream has reached it and, for a wait, its word
passes. The search visits every reachable state once (states are
deduplicated) and asserts that no store overwrites a slot its owner has not
read yet, that no wait passes before the neighbour's store of that
exchange has landed, that every read finds the bytes of its own exchange,
and that the ring never deadlocks before every rank has finished.

kParities, kWords and the wait rule are read from the source, so the model
cannot drift from it. Two negative controls show that the checker bites:
one slot instead of two parities, and the signals issued before the stores.
"""

import pathlib
import re
import time

import pytest

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "savgol_tpu_torch"
          / "csrc" / "halo_ring.cu")

# (ring size, exchanges): every interleaving of each is searched
RINGS = [(2, 6), (3, 4), (4, 3), (5, 2)]

# the steps of one exchange, in stream order: (kind, side); side 0 = LEFT
SEND_FIRST = (("store", 0), ("store", 1), ("signal", 0), ("signal", 1),
              ("wait", 0), ("wait", 1), ("read", 0), ("read", 1))
SIGNAL_FIRST = (("signal", 0), ("signal", 1), ("store", 0), ("store", 1),
                ("wait", 0), ("wait", 1), ("read", 0), ("read", 1))

# CUstreamWaitValue_flags rules, on the small epochs of the model
# (the cyclic comparison of GEQ is the plain one there)
RULES = {"GEQ": lambda word, want: word - want >= 0,
         "EQ": lambda word, want: word == want}


def source_constants() -> dict:
    """kParities, kWords and the wait rule's name, from halo_ring.cu."""
    text = SOURCE.read_text()

    def grab(pattern):
        m = re.search(pattern, text)
        assert m, f"{pattern!r} not found in {SOURCE.name}"
        return m.group(1)

    return {"parities": int(grab(r"constexpr int kParities = (\d+);")),
            "words": int(grab(r"constexpr int kWords = (\d+);")),
            "rule": grab(r"constexpr unsigned kWaitRule = "
                         r"CU_STREAM_WAIT_VALUE_(\w+);")}


def search(ring: int, epochs: int, parities: int, words: int, rule: str,
           order=SEND_FIRST):
    """(first violation or None, states visited). A state is each rank's
    next step, its arrival words, and its slots as (epoch held, read)."""
    passes = RULES[rule]
    steps = [(e, kind, side) for e in range(1, epochs + 1)
             for kind, side in order]
    n_slots = parities * 2
    start = ((0,) * ring, ((0,) * words,) * ring,
             (((0, True),) * n_slots,) * ring)
    seen = {start}
    stack = [start]
    while stack:
        pcs, wds, slots = stack.pop()
        moved = False
        for r in range(ring):
            if pcs[r] == len(steps):
                continue
            e, kind, side = steps[pcs[r]]
            p = e % parities
            new_w, new_s = wds, slots
            if kind == "store":
                # LEFT: my tail -> the right neighbour's left slot; RIGHT: my
                # head -> the left neighbour's right slot
                t = (r + 1) % ring if side == 0 else (r - 1) % ring
                k = 2 * p + side
                held, read = slots[t][k]
                if not read:
                    return (f"ring {ring}: rank {r}'s store of exchange {e} "
                            f"overwrote rank {t}'s unread slot of exchange "
                            f"{held}"), len(seen)
                row = list(slots[t])
                row[k] = (e, False)
                new_s = slots[:t] + (tuple(row),) + slots[t + 1:]
            elif kind == "signal":
                # e into the right neighbour's LEFT word (side 0) or the left
                # neighbour's RIGHT word (side 1)
                t = (r + 1) % ring if side == 0 else (r - 1) % ring
                row = list(wds[t])
                row[side] = e
                new_w = wds[:t] + (tuple(row),) + wds[t + 1:]
            elif kind == "wait":
                if not passes(wds[r][side], e):
                    continue
                held, _ = slots[r][2 * p + side]
                if held != e:
                    return (f"ring {ring}: rank {r}'s wait of exchange {e} "
                            f"passed on side {side} before the neighbour's "
                            f"store (slot holds {held})"), len(seen)
            else:   # read
                k = 2 * p + side
                held, _ = slots[r][k]
                if held != e:
                    return (f"ring {ring}: rank {r} read exchange {held} "
                            f"for {e} on side {side}"), len(seen)
                row = list(slots[r])
                row[k] = (held, True)
                new_s = slots[:r] + (tuple(row),) + slots[r + 1:]
            moved = True
            nxt = (pcs[:r] + (pcs[r] + 1,) + pcs[r + 1:], new_w, new_s)
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
        if not moved and any(pc < len(steps) for pc in pcs):
            return (f"ring {ring}: deadlock with the ranks at steps "
                    f"{[steps[pc] if pc < len(steps) else 'done' for pc in pcs]}"
                    ), len(seen)
    return None, len(seen)


def test_constants_are_read_from_the_source():
    c = source_constants()
    assert c["parities"] >= 1 and c["words"] == 2
    assert c["rule"] in RULES


@pytest.mark.parametrize("ring,epochs", RINGS)
def test_protocol_holds_in_every_interleaving(ring, epochs):
    t0 = time.perf_counter()
    c = source_constants()
    bad, states = search(ring, epochs, **c)
    assert bad is None, bad
    assert states > 8 * epochs * ring
    assert time.perf_counter() - t0 < 10.0


@pytest.mark.parametrize("ring,epochs", [(2, 3), (3, 2)])
def test_checker_catches_one_slot_a_side(ring, epochs):
    """Negative control: with one slot instead of two parities a
    neighbour's next exchange can overwrite a slot before it is read."""
    c = source_constants()
    bad, _ = search(ring, epochs, 1, c["words"], c["rule"])
    assert bad is not None and ("overwrote" in bad or "read exchange" in bad)


@pytest.mark.parametrize("ring,epochs", [(2, 2), (3, 2)])
def test_checker_catches_signal_before_stores(ring, epochs):
    """Negative control: signalling before the stores lets a wait pass
    before the neighbour's bytes have landed."""
    c = source_constants()
    bad, _ = search(ring, epochs, **c, order=SIGNAL_FIRST)
    assert bad is not None and "before the neighbour's store" in bad


def test_checker_catches_an_equality_wait():
    """An equality wait deadlocks: a neighbour one exchange ahead has
    already moved the word past the epoch this rank waits for."""
    c = source_constants()
    bad, _ = search(2, 3, c["parities"], c["words"], "EQ")
    assert bad is not None and "deadlock" in bad
