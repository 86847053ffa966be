"""Train state of the port: the step counter.

The model (parameters and BN statistics) and the optimizer hold the rest of
what the JAX package's ``TrainState`` carries; EMA waits for a later slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainState:
    step: int = 0
