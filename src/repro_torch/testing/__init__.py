"""Deterministic test harnesses (fault injection for the decode service);
port of ``repro.testing``."""
from .faults import (FaultInjector, FaultSpec,           # noqa: F401
                     InjectedFault, InjectedKernelError)

__all__ = ["FaultInjector", "FaultSpec", "InjectedFault",
           "InjectedKernelError"]
