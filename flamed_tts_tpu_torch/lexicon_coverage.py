"""English-frontend lexicon coverage on running text, as the JAX package's
``tools/lexicon_coverage.py`` measures it:

    python -m flamed_tts_tpu_torch.lexicon_coverage [textfile] [--lexicon-dir DIR]

The share of running words (and of unique words) that the port's frontend
resolves by (a) a lexicon hit, (b) inflection of a lexicon stem, (c) the
neural G2P where its weights are present, (d) the letter-to-sound rules.
With no file, the built-in ~600-word mixed-register sample.  Prints one
JSON line, the JAX tool's.  Host-only; no device.
"""

from __future__ import annotations

import argparse
import json
import re
from collections import Counter
from typing import Optional, Sequence

from flamed_tts_tpu_torch.text.frontend import EnglishFrontend, _WORD_SPLIT_RE, inflect_oov
from flamed_tts_tpu_torch.text.neural_g2p import DEFAULT_LEXICON_DIR
from flamed_tts_tpu_torch.text.numbers_norm import normalize_numbers

# Mixed-register running text: deliberately ordinary English across four
# registers, not cherry-picked for the lexicon.
SAMPLE = """
The city council voted on Tuesday to approve the new transportation
budget, despite objections from several residents who argued that the
proposal failed to address rising maintenance costs. Officials estimated
that repairs to the aging bridges would require nearly thirty million
dollars over the next five years, and the mayor acknowledged that
federal assistance remained uncertain.

She walked slowly along the narrow path between the trees, listening to
the birds and watching the light shift through the leaves. Her
grandmother's house stood at the edge of the village, its wooden shutters
painted a faded blue. Inside, the kitchen smelled of bread and cinnamon,
and the old clock ticked quietly on the mantelpiece. They talked for
hours about everything and nothing, laughing at stories they had told
each other a hundred times before.

The experiment measured how quickly the enzyme catalyzed the reaction at
different temperatures. Researchers recorded the concentration every
fifteen seconds and plotted the results against the theoretical model.
The observed rates deviated significantly above forty degrees,
suggesting that the protein structure became unstable. Further analysis
confirmed that the mutation reduced binding efficiency by roughly half,
a finding with implications for drug development.

Honestly, I wasn't expecting the restaurant to be that crowded on a
Wednesday night. We waited almost an hour for a table, but the food was
definitely worth it. My brother ordered the grilled salmon and couldn't
stop talking about the sauce. Afterwards we wandered downtown, grabbed
some ice cream, and caught the late train home. You should come with us
next time; I promise you'll enjoy it.

The quarterly earnings report exceeded expectations, driven by strong
international sales and improved operating margins. Management raised
its full-year guidance and announced an expanded share repurchase
program. Analysts nevertheless cautioned that currency headwinds and
supply chain disruptions could pressure profitability in subsequent
quarters, particularly if consumer demand weakens across European
markets.

Gabriela Okonkwo flew from Ljubljana to Reykjavik on Wednesday, changing
planes in Copenhagen before continuing to Winnipeg. Her colleague
Siddharth Venkataraman had already checked into the Marriott near the
Schaumburg convention center, where delegates from Guadalajara,
Bratislava, and Thessaloniki were debating quinoa tariffs, kombucha
labeling, and the pronunciation of foie gras. Keynote speakers included
Professor Nakamura of Kyoto and Dr. Przybylski of Gdansk, whose
fjord-mapping startup Skyrdalur had recently acquired a lidar firm in
Oaxaca.
"""


def classify(frontend: EnglishFrontend, word: str) -> str:
    if frontend._lookup(word) is not None:
        return "lexicon"
    if inflect_oov(word, frontend._lookup) is not None:
        return "inflection"
    # OOV fallback: the trained neural G2P when its weights are present
    # (frontend.word_to_phones order), letter-to-sound rules otherwise.
    if frontend._neural_g2p() is not None:
        return "neural_g2p"
    return "rules"


def coverage(text: str, lexicon_dir: str = DEFAULT_LEXICON_DIR) -> dict:
    fe = EnglishFrontend(lexicon_dir=lexicon_dir)
    text = normalize_numbers(text)
    words = [
        w for w in _WORD_SPLIT_RE.split(text)
        if w and not _WORD_SPLIT_RE.fullmatch(w) and re.search(r"[A-Za-z]", w)
    ]
    counts = Counter(classify(fe, w) for w in words)
    total = sum(counts.values())
    uniq = {w.lower() for w in words}
    uniq_counts = Counter(classify(fe, w) for w in uniq)
    return {
        "running_words": total,
        "lexicon_pct": round(100 * counts["lexicon"] / total, 1),
        "inflection_pct": round(100 * counts["inflection"] / total, 1),
        "neural_g2p_pct": round(100 * counts["neural_g2p"] / total, 1),
        "rules_pct": round(100 * counts["rules"] / total, 1),
        "unique_words": len(uniq),
        "unique_lexicon_pct": round(100 * uniq_counts["lexicon"] / len(uniq), 1),
        "unique_oov_words": sorted(
            w for w in uniq if classify(fe, w) in ("neural_g2p", "rules")
        ),
        "lexicon_entries": len(fe.builtin),
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.lexicon_coverage",
                                     description="Lexicon coverage of running text (one JSON line).")
    parser.add_argument("textfile", nargs="?", default=None)
    parser.add_argument("--lexicon-dir", default=DEFAULT_LEXICON_DIR,
                        help="The frontend's lexicon directory (default: the JAX package's lexicon/).")
    args = parser.parse_args(argv)
    text = SAMPLE
    if args.textfile:
        with open(args.textfile, encoding="utf-8") as fin:
            text = fin.read()
    print(json.dumps(coverage(text, args.lexicon_dir)))


if __name__ == "__main__":
    main()
