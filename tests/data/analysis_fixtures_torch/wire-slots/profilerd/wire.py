"""Seeded violation: a wire record dataclass without slots."""

from dataclasses import dataclass


@dataclass
class Sample:  # SEEDED: no slots=True, no __slots__
    t: float
    tid: int


@dataclass(slots=True)
class GoodRecord:  # control: this one must NOT be flagged
    n: int
