"""``python -m trainner_tpu_torch.train -opt <options>``: the training CLI
(``train/cli.py``)."""

from .cli import main

if __name__ == "__main__":
    main()
