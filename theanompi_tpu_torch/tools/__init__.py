"""The port's command-line tools, each run as ``python -m
theanompi_tpu_torch.tools.<name>``.  A tool that runs a model or stages a
batch runs on the card; ``--host-devices N`` asks for the CPU (N gloo
ranks, one thread each, started through the launcher by ``_world.py``),
and without it a tool that finds no GPU fails.  Outputs go to ``--out``
(or ``PROFILE_DIR``), under ``build/tools/`` by default.

Operations:

* ``telemetry_report`` — the run report over a ``record_dir``: phases,
  throughput, the straggler ranking (which ``parallel/membership.py``'s
  controller demotes by), health flags, distributed traces, ``--json``,
  ``--trace`` (Perfetto);
* ``fleetz`` — one live table of every process registered in a run
  directory over ``statusz``, the fleet monitor's alerts; ``--json``,
  ``--events``, ``--watch``; exit 2 when a row is DOWN;
* ``plot_records`` — a run's training records as PNG curves;
* ``profile_model`` — one model's traced step through ``utils/devprof``:
  top op classes, compute against collective time, exposed comm,
  ``--schedule``, ``--json``;
* ``loader_bench`` — the host input pipeline's images and GB a second
  (``--u8-wire``, ``--prefetch``, ``--windows``) and, on the card, the
  pinned staging rate;
* ``simfleet_run`` — rehearse a fault schedule at production width in
  virtual time (``simfleet``), its determinism gate, and the live
  fidelity cross-check;
* ``chaos_run`` — an audited chaos run of the elastic islands or of a
  supervised BSP world.

The paper's experiments:

* ``scaling_sweep`` — time per 5120 images by worker count × strategy,
  ``--measure-comm``;
* ``rules_time_to_acc`` — time to accuracy of BSP, EASGD, ASGD and GoSGD
  through the session API;
* ``async_vs_sync_easgd`` — islands against synchronous-cadence EASGD,
  samples a second and their ratio;
* ``gosgd_mixing`` — GoSGD's mixing rate for ``perm``, ``shift`` and
  ``iid`` (``--k-sweep``); two ranks or more.

The lint:

* ``lint`` — the whole-program checks of the port: its host code, what
  runs on the card and across ranks, and its kernels' plain/test/card
  triples, with its baseline (``tpulint_torch_baseline.json``);
* ``precommit_lint`` — the lint over the staged content, as a git
  pre-commit hook;
* ``explain_program`` — the kernel-library cache's manifest, and which
  key part split two entries.
"""
