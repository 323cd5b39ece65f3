"""Metadata-file batch synthesis, the documented command line of the
reference's ``synthesize_via_metadata.py`` on the port:

    python -m flamed_tts_tpu_torch.synthesize_via_metadata --text-file meta.txt \\
        --ckpt-path ... --cfg-path ... --prompt-dir ... [--output-dir ...]

A thin wrapper of ``python -m flamed_tts_tpu_torch.synthesize
--metadata-file``; it requires ``--text-file`` (or ``--metadata-file``).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from flamed_tts_tpu_torch import synthesize


def main(argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith(("--text-file", "--metadata-file")) for a in argv):
        print("synthesize_via_metadata requires --text-file", file=sys.stderr)
        sys.exit(2)
    return synthesize.main(synthesize.build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    main()
