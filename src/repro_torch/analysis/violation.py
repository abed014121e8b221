"""The record every checker of ``repro_torch.analysis`` reports: one
broken rule, with the family it was found in (the geometry or pool
checked), the operand (a band, a level, a page), the kind of rule and a
readable detail.  The reference's own ``Violation`` (its kernels
checker's), field for field, so that the CLI's JSON report keeps the
reference's schema."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Violation:
    family: str
    operand: str
    kind: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.family}] {self.operand}: {self.kind}: {self.detail}"
