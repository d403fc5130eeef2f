"""``visualize_solutions``: the self-contained HTML report of a results
store's solutions (``visualize.py``).

    python3 -m remixt_tpu_torch.ui.main visualize_solutions results.h5 \\
        report.html
"""

from remixt_tpu_torch import visualize


def create_visualization(**args):
    visualize.create_solutions_visualization(args['results'], args['html'])


def add_arguments(argparser):
    argparser.add_argument('results', help='Results to visualize')
    argparser.add_argument('html', help='HTML output visualization')
    argparser.set_defaults(func=create_visualization)
