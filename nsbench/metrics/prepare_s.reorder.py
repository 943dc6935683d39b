"""prepare_s.reorder: host seconds of the ``reorder`` stage of the program's
newest ``prepare`` span that is not part of the transpose plan's build
(the configuration's ``from_coo`` in set-up)."""
from nsbench import program_spans as spans


def read(run):
    return spans.prepare_stage_s("reorder")
