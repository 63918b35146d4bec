"""Fixture canonical table: registers KNOWN_KIND only."""

KNOWN_KIND = "KNOWN_KIND"

EVENT_KINDS = frozenset({KNOWN_KIND})
