"""Sync-rule session API.

Counterpart of ``theanompi_tpu/sync_rule.py``: the three calls every
reference session script made,

    from theanompi_tpu_torch import BSP
    rule = BSP()
    rule.init(devices=1, modelfile='theanompi_tpu_torch.models.alex_net',
              modelclass='AlexNet')
    rule.wait()

``wait()`` runs this process's rank in-process and returns the recorder.
One process drives one GPU: ``devices`` is the world size (an int, or a
list whose length counts), and a world of more than one needs one process
per rank, each given its ``rank`` and the group's ``init_method``.

``BSP``, ``EASGD``, ``ASGD`` and ``GOSGD`` name the rule; the async rules
run in their default synchronous-cadence mode (``easgd_mode`` /
``asgd_mode`` ``'sync'``).  Their asynchronous islands around a host-side
center are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from .worker import WORKERS


class SyncRule:
    rule = "bsp"

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        self.worker = None
        self.model = None
        self.recorder = None

    def init(self, devices: Union[int, Sequence, None] = None,
             modelfile: str = "theanompi_tpu_torch.models.alex_net",
             modelclass: str = "AlexNet", **kwargs) -> "SyncRule":
        """Record topology + model selection."""
        if devices is not None and not isinstance(devices, int):
            devices = len(list(devices))
        self.config.update(kwargs)
        self.config["n_workers"] = devices or 1
        self.config["rule"] = self.rule
        self.modelfile, self.modelclass = modelfile, modelclass
        return self

    def wait(self):
        """Run training to completion and return the recorder.  The process
        group this rank created is left again on the way out."""
        self.worker = WORKERS[self.rule](self.config)
        try:
            self.model = self.worker.build_model(self.modelfile,
                                                 self.modelclass)
            self.recorder = self.worker.run(self.model)
        finally:
            self.worker.close()
        return self.recorder


class BSP(SyncRule):
    rule = "bsp"


class _SyncCadence(SyncRule):
    """An async rule in its synchronous-cadence mode; ``<rule>_mode=
    'async'`` (worker islands around a center) is refused."""

    def wait(self):
        mode = self.config.get(f"{self.rule}_mode", "sync")
        if mode != "sync":
            raise NotImplementedError(
                f"{self.rule}_mode={mode!r}: the asynchronous islands are "
                f"not ported yet (A8b); use 'sync'")
        return super().wait()


class EASGD(_SyncCadence):
    """Elastic averaging with a center every rank keeps a copy of:
    ``alpha`` (0.5), ``sync_freq`` (4)."""

    rule = "easgd"


class ASGD(_SyncCadence):
    """Downpour push-pull through the center: ``sync_freq`` (1)."""

    rule = "asgd"


class GOSGD(SyncRule):
    """Gossip: ``exch_prob`` (0.25), ``gosgd_peers`` (``'perm'``,
    ``'shift'``, ``'iid'``), ``gosgd_n_perms`` (16), ``gosgd_seed`` (0)."""

    rule = "gosgd"
