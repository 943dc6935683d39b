"""``"generator": "sbm"``: the program's block-model graph, frozen
(``graphs.sbm_structure``): ``n``, ``avg_deg``, ``n_classes``,
``homophily``, ``symmetric``, ``seed``.  Its values are the normalised
adjacency's, and its labels each node's community."""
from nsbench import graphs


def build(g, device):
    rows, cols, vals, labels = graphs.sbm_structure(
        g["n"], g["avg_deg"], g["n_classes"], g["seed"], g["homophily"],
        g["symmetric"])
    return rows, cols, vals, (g["n"], g["n"]), labels
