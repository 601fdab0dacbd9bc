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

``BSP``, ``EASGD``, ``ASGD`` and ``GOSGD`` name the rule.  EASGD and ASGD
run by default in their synchronous-cadence mode (``easgd_mode`` /
``asgd_mode`` ``'sync'``: the exchange inside this rank's step); in
``'async'`` mode ``wait()`` trains worker islands around a host-side
center instead (``parallel/async_easgd.py``: islands that are threads of
this process, one device each, and a center in memory, served over TCP
with ``center_serve``, or joined at ``center_addr``) for ``run_seconds``
and returns the islands' trainer.
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

    def wait(self, prepare=None):
        """Run training to completion and return the recorder.  ``prepare``,
        when given, is called as ``prepare(worker, model)`` on the built
        model before its run (to load its starting parameters, say).  The
        process group this rank created is left again on the way out."""
        self.worker = WORKERS[self.rule](self.config)
        try:
            self.model = self.worker.build_model(self.modelfile,
                                                 self.modelclass)
            if prepare is not None:
                prepare(self.worker, self.model)
            self.recorder = self.worker.run(self.model)
        finally:
            self.worker.close()
        return self.recorder


class BSP(SyncRule):
    rule = "bsp"


def _run_async_islands(rule_obj, rule_name: str):
    """EASGD's and ASGD's async mode: islands around a center
    (``parallel.async_easgd``) for ``run_seconds`` (60); returns the
    trainer, whose ``stats()`` / ``epoch_records`` hold the islands' and
    the center's progress."""
    import importlib

    from .parallel.async_easgd import AsyncEASGDTrainer

    mod = importlib.import_module(rule_obj.modelfile)
    cls = getattr(mod, rule_obj.modelclass)
    cfg = dict(rule_obj.config)
    rule_obj.trainer = AsyncEASGDTrainer(cls, cfg, rule=rule_name)
    rule_obj.trainer.run_for(float(cfg.get("run_seconds", 60.0)))
    return rule_obj.trainer


class _CenterRule(SyncRule):
    """An async rule with a center: ``<rule>_mode='sync'`` (default) runs
    the exchange inside this rank's step, ``'async'`` the islands."""

    def wait(self, prepare=None):
        mode = self.config.get(f"{self.rule}_mode", "sync")
        if mode == "async":
            if prepare is not None:
                raise ValueError("prepare applies to the 'sync' mode; the "
                                 "islands build their own models")
            return _run_async_islands(self, self.rule)
        if mode != "sync":
            raise ValueError(f"{self.rule}_mode={mode!r}; have 'sync', "
                             f"'async'")
        return super().wait(prepare)


class EASGD(_CenterRule):
    """Elastic averaging with a center: ``alpha`` (0.5), ``sync_freq`` (4);
    ``easgd_mode='async'``: islands around a host-side center
    (``async_islands``, ``center_serve`` / ``center_addr``,
    ``run_seconds``)."""

    rule = "easgd"


class ASGD(_CenterRule):
    """Downpour push-pull through the center: ``sync_freq`` (1);
    ``asgd_mode='async'``: downpour islands around a host-side center."""

    rule = "asgd"


class GOSGD(SyncRule):
    """Gossip: ``exch_prob`` (0.25), ``gosgd_peers`` (``'perm'``,
    ``'shift'``, ``'iid'``), ``gosgd_n_perms`` (16), ``gosgd_seed`` (0)."""

    rule = "gosgd"
