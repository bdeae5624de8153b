"""Engine context: the reference's `LSHServer` without mutable globals.

Counterpart of `similaritysearchbyrdf_tpu/deploy/server.py`. The reference
keeps the active hash engine and the data-format flag in two globals
(`LSHServer.scala:5-18`); here they belong to an object the front ends
own, and a module-level instance exists only for familiarity. Its device is
resolved when the engine is made, never at import.
"""

from __future__ import annotations

from typing import Optional

from ..config import RDFConfig
from ..models.families import Device, HashModel, generate_model


class LSHServer:
    """Holds the active hash engine and data-format flag of a deployment,
    on `device` (default: the first CUDA card)."""

    def __init__(self, device: Device = None) -> None:
        self.device = device
        self.lsh_engine: Optional[HashModel] = None
        self.conf: Optional[RDFConfig] = None
        self.is_use_dense: bool = True

    def init_engine(self, conf: RDFConfig) -> HashModel:
        self.conf = conf
        self.is_use_dense = conf.feature_data_format == "dense"
        self.lsh_engine = generate_model(conf, device=self.device)
        return self.lsh_engine


default_server = LSHServer()
