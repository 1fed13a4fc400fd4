from svbfm.ops.segment import sorted_segment_sum  # noqa: F401
from svbfm.ops.forward import fm_scores, fm_scores_and_sums, fm_t_terms  # noqa: F401
