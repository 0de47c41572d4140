"""python -m fasterrcnn_torch --help: the CLI of `fasterrcnn_torch/cli.py`.

A shim: a spawned rank of --num-devices imports `fasterrcnn_torch.cli`, and
would not re-import this module."""

from fasterrcnn_torch.cli import *  # noqa: F401,F403

if __name__ == "__main__":
    main()  # noqa: F405
