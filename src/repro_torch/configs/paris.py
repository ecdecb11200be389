"""The paper's own workload: a ParIS+ index over a 100M x 256 random-walk
dataset (the paper's default synthetic benchmark), with w = 16 segments
and 256-symbol cardinality.

The port's copy of ``repro/configs/paris.py``. The mesh (``core/
distributed.py``) and ``chip_smoke.py``'s mesh phase read their round
size and leaf cap from :data:`CONFIG`; one H100 holds 2^24 of the 100M
series, so the card's runs cut ``num_series`` and keep every width.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ParisConfig:
    """One ParIS+ deployment: data scale, series shape and index knobs."""

    name: str = "paris"
    family: str = "index"
    num_series: int = 100_000_000  # 100M series (paper's 100GB dataset)
    series_length: int = 256
    segments: int = 16
    cardinality: int = 256
    queries_per_batch: int = 1
    round_size: int = 4096
    leaf_cap: int = 256


CONFIG = ParisConfig()


def smoke_config() -> ParisConfig:
    """The same index at test size: 4096 series of length 64."""
    return ParisConfig(name="paris-smoke", num_series=4096, series_length=64,
                       segments=8, round_size=256, leaf_cap=32)
