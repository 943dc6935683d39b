"""prepare_s.transpose: host seconds of the program's
``transpose_structure`` span: the transpose plan's ``prepare``, which the
first backward builds in set-up."""
from nsbench import program_spans as spans


def read(run):
    return spans.transpose_s()
