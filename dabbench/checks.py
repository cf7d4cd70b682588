"""The comparison that decides ``correct``: every answer of the window
against the plain reference's answer to the same input.

Every answer the window produced is compared, by the entry adapter that
made the call (its ``expect`` and ``compare``); of an output over a
megabyte (a bulk call's decoded bytes or audio) the rows that the caller
kept, a sample drawn from the seed (``calls.Caller``). Three numbers,
each with the limit 0, since the program is bit-exact with the reference
by its contract (the DLL's numerics):

* ``missing``: calls that raised, returned nothing, or never ran;
* ``bytes_wrong``: bytes of decoded frames, audio or an export's output
  buffer (the -1 prefix write included) that differ;
* ``codes_wrong``: RS error counts and return codes that differ (an
  expected -1 on an uncorrectable codeword is an answer, not a failure).

``failed`` counts the events (a loop with ``PER_EVENT``) or calls with
any such fault; ``attempted`` all of them.
"""

from __future__ import annotations

import numpy as np

from .calls import Sample

LIMITS = {"missing": 0, "bytes_wrong": 0, "codes_wrong": 0}


def bytes_wrong(got, want) -> int:
    """Differing bytes; of a kept sample, in its rows (a wrong shape:
    every byte)."""
    if isinstance(got, Sample):
        if got.shape != want.shape:
            return int(want.size)
        got, want = got.values, want[got.rows]
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


def code_and_bytes(got, want) -> dict:
    """An export's (return code, output bytes) against the reference's."""
    return {"codes_wrong": int(got[0] != want[0]),
            "bytes_wrong": bytes_wrong(got[1], want[1])}


def check_call(rec, table, workload) -> dict:
    """The three numbers for one recorded call."""
    out = dict.fromkeys(LIMITS, 0)
    if rec.error is not None or rec.out is None:
        out["missing"] = 1
        return out
    c = rec.call
    _, entry = workload.entries[c.role]
    pool = workload.pools[c.pool]
    out.update(entry.compare(rec.out, entry.expect(table, pool, c)))
    return out


def compare(events, table, workload, per_event: bool):
    """(numbers, attempted, failed) over every event of the window."""
    total = dict.fromkeys(LIMITS, 0)
    attempted = failed = 0
    for ev in events:
        if ev.done is None:                  # due, never ran
            attempted += 1
            failed += 1
            total["missing"] += 1
            continue
        bad_event = False
        for rec in ev.records:
            got = check_call(rec, table, workload)
            bad = any(got.values())
            for k, v in got.items():
                total[k] += v
            if not per_event:
                attempted += 1
                failed += bad
            bad_event |= bad
        if per_event:
            attempted += 1
            failed += bad_event
    return total, attempted, failed
