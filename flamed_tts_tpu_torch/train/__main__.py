"""``python -m flamed_tts_tpu_torch.train``: the training CLI (``cli.py``)."""

from flamed_tts_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
