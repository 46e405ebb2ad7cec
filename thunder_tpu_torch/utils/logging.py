"""Structured per-round metrics (thunder_tpu.utils.logging.RoundMetrics):
one JSON object a line."""

from __future__ import annotations

import json


class RoundMetrics:
    """JSONL per-round metrics sink (a structured upgrade over the
    reference's Class_Info/FSC text files)."""

    def __init__(self, path: str):
        self.path = path

    def write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
