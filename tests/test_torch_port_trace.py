"""The port's trace helpers on the CPU: `profile_step.device_trace`, the
layout every device trace of chip_smoke.py and profile_step takes (idle
host time at both ends, so that a record whose card timestamp runs past the
host's clock still falls inside the trace), and `trace_edges.compare`, which
finds the records a trace lost and whether they were its first or its last.
Neither has a counterpart in the JAX package."""

import pytest
import torch

from flexflow_tpu_torch import profile_step, trace_edges


def test_device_trace_idles_at_both_ends(monkeypatch):
    events = []
    monkeypatch.setattr(profile_step.time, "sleep", lambda s: events.append(("sleep", s)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: events.append("synchronize"))
    with profile_step.device_trace() as prof:
        events.append("block")
    edge = profile_step.TRACE_EDGE_S
    assert edge >= 0.1  # well above the clock offsets seen on the card
    assert events == [("sleep", edge), "block", "synchronize", ("sleep", edge)]
    assert isinstance(prof, torch.profiler.profile)


def test_device_trace_lets_the_block_raise(monkeypatch):
    monkeypatch.setattr(profile_step.time, "sleep", lambda s: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(RuntimeError, match="inside"):
        with profile_step.device_trace():
            raise RuntimeError("inside")


STEP = ["Memcpy HtoD", "Memcpy DtoD", "bf16 copy", "ff_flash_fwd_kernel", "ff_flash_delta_kernel",
        "ff_flash_bwd_dkv_kernel", "ff_flash_bwd_dq_kernel", "adam", "Memcpy DtoH"]


@pytest.mark.parametrize("cut, where", [
    (slice(None), None),  # whole
    (slice(2, None), "first"),  # the first window's input copies
    (slice(None, -4), "last"),  # the last step's backward and update
])
def test_compare_finds_the_lost_records_and_their_end(cut, where):
    full = STEP * 4
    closed, edged = "closed at the fit", "idle edges"
    records, summary = trace_edges.compare([(edged, full), (closed, full[cut])], whole=4)
    rec = records[1]
    lost = len(full) - len(full[cut])
    assert rec["records"] == len(full) - lost
    assert sum(rec["lost"].values()) == lost
    assert rec["flash_whole"] == (where != "last")
    assert (rec["agree_from_start"] == 0) == (where == "first")
    assert (rec["agree_from_end"] == 0) == (where == "last")
    assert summary[edged] == {"traces": 1, "short": 0, "flash_not_whole": 0, "lost_first": 0,
                              "lost_last": 0, "most_records_lost": 0}
    assert summary[closed]["short"] == (lost > 0)
    assert summary[closed]["lost_first"] == (where == "first")
    assert summary[closed]["lost_last"] == (where == "last")
    assert summary[closed]["most_records_lost"] == lost
