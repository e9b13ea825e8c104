from .phred import (
    phred_char_to_p_correct,
    p_correct_to_phred_char,
    phred_to_p_correct_table,
    log_avg,
    normalize_log,
)
from .timing import timestamp, log_progress, Stats
