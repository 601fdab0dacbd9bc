"""The port's command-line tools, each run as ``python -m
theanompi_tpu_torch.tools.<name>``:

* ``simfleet_run`` — rehearse a fault schedule at production width in
  virtual time (``simfleet``), its determinism gate, and the live
  fidelity cross-check;
* ``chaos_run`` — an audited chaos run of the elastic islands or of a
  supervised BSP world;
* ``lint`` — the whole-program checks of the port: its host code, what
  runs on the card and across ranks, and its kernels' plain/test/card
  triples, with its baseline (``tpulint_torch_baseline.json``);
* ``precommit_lint`` — the lint over the staged content, as a git
  pre-commit hook;
* ``explain_program`` — the kernel-library cache's manifest, and which
  key part split two entries.
"""
