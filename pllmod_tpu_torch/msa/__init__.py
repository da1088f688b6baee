"""MSA handling: IO, statistics, empirical parameters, filtering.

Counterpart of ``src/msa/pll_msa.c`` plus the libpll FASTA/PHYLIP readers
(SURVEY.md §2.3, §2.9 I/O).
"""

from pllmod_tpu_torch.msa.msa import (  # noqa: F401
    MSA,
    STATS_DUP_TAXA,
    STATS_DUP_SEQS,
    STATS_GAP_PROP,
    STATS_GAP_SEQS,
    STATS_GAP_COLS,
    STATS_INV_PROP,
    STATS_INV_COLS,
    STATS_FREQS,
    STATS_SUBST_RATES,
    STATS_ALL,
    empirical_frequencies,
    empirical_subst_rates,
    empirical_invariant_sites,
    check_msa,
    compute_stats,
)
from pllmod_tpu_torch.msa.io import (  # noqa: F401
    read_fasta,
    read_phylip,
    write_fasta,
    write_phylip,
    load_msa,
)
