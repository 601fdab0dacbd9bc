"""The port's lint: ``python -m theanompi_tpu_torch.tools.lint``.

    python -m theanompi_tpu_torch.tools.lint                   # the tree
    python -m theanompi_tpu_torch.tools.lint --check-baseline  # the gate
    python -m theanompi_tpu_torch.tools.lint --diff HEAD       # changed files
    python -m theanompi_tpu_torch.tools.lint --list-checks

The flags and exit codes are ``analysis/cli.py``'s.  The process imports
neither ``jax`` nor the JAX package; the package ``__init__`` is lazy, so
nothing of the training stack loads unless a schema-drift probe asks for
it.
"""

import sys

from ..analysis import cli


def main(argv=None) -> int:
    return cli.main(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    raise SystemExit(main())
