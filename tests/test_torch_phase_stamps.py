"""The phase profiler (``repro_torch.launch.profile_band_phases``) stamps
the kernel sources at fixed lines of their text.  For every ``--kernel``
target, every anchor is found once in this tree's sources, every stamp
lands once, and the stamped source only adds lines to the original, so
each target builds the kernel it names on the card."""
import difflib

import pytest

from repro_torch.kernels import _build
from repro_torch.launch import profile_band_phases as pb


@pytest.mark.parametrize("kernel", sorted(pb.TARGETS))
def test_every_stamp_lands_once(kernel):
    stem, specs = pb.TARGETS[kernel]
    src = (_build.CSRC / f"{stem}.cu").read_text()
    out = pb.instrumented_source(src, specs)
    for k in range(1, max(len(s["phases"]) for s in specs)):
        want = sum(len(s["phases"]) > k for s in specs)
        assert out.count(f"ph_acc[{k}] += ") == want, k
    for spec in specs:                 # the sums stored at the last stamp
        assert out.count(f"{spec['array']}[blockIdx.y") == len(
            spec["phases"])
    ops = difflib.SequenceMatcher(None, src.splitlines(), out.splitlines(),
                                  autojunk=False).get_opcodes()
    assert {tag for tag, *_ in ops} <= {"equal", "insert"}
