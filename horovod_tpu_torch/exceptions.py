"""Exception hierarchy for the elastic/fault-tolerance contract.

Copy of ``horovod_tpu/exceptions.py`` (the port keeps its own copy: it
imports nothing of the JAX package).

Mirrors the reference semantics of horovod/common/exceptions.py:18,26: a failed
collective raises ``HorovodInternalError`` which the elastic ``run`` wrapper
catches to restore state from the last commit; a host-membership change raises
``HostsUpdatedInterrupt`` which commits and re-initializes without state loss.
"""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective routine fails.

    Under ``horovod_tpu.elastic.run`` this triggers ``state.restore()`` from the
    last in-memory commit followed by re-initialization over the surviving hosts.
    """


class CollectiveRejectedError(HorovodInternalError):
    """A coordinator-published error verdict for a negotiated collective
    (the ERROR Response of controller.cc ConstructResponse).

    Distinct from other ``HorovodInternalError``s because a rejection is
    SYMMETRIC: every participating rank raised it, so nobody entered the
    device collective — a joined rank's replay loop may log it and keep
    servicing, whereas a local timeout must propagate."""


class RendezvousUnreachableError(HorovodInternalError):
    """The launcher's rendezvous KV server refused connections for a
    sustained window — the launcher is presumed dead.  Unlike a transient
    reset failure this is NOT retried: without a rendezvous there is no
    world to rejoin, so the worker terminates promptly instead of polling
    out the full elastic timeout."""


class HostsUpdatedInterrupt(Exception):
    """Raised when the set of participating hosts changes mid-training.

    ``skip_sync`` is True when the update does not require re-broadcasting state
    (pure scale-up discovered before any rank failed).
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class HorovodVersionMismatchError(ImportError):
    """Raised when launcher and worker framework versions disagree."""


class TensorShapeMismatchError(ValueError):
    """Raised when ranks submit mismatched shapes to one named collective.

    The reference detects this in the coordinator's ``ConstructResponse``
    (controller.cc:496) and delivers an error Response to every rank's status
    callback; here it surfaces as an exception from the negotiation layer.
    """


class DuplicateNameError(ValueError):
    """Two in-flight collectives share one name (common.h:239 DUPLICATE_NAME_ERROR)."""
