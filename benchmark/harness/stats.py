"""The statistics the metrics are made of."""
import statistics
from typing import Sequence


def median(values: Sequence[float]) -> float:
    return statistics.median(values)
