"""Results viewer: builds the self-contained HTML report of a results
store's solutions (``visualize.create_solutions_visualization``) and
serves it on localhost. Run:

    python -m remixt_tpu_torch.tools.remixt_viewer_app results.h5 [--port 8000]
"""

import argparse
import functools
import http.server
import os
import tempfile

from remixt_tpu_torch import visualize


def build(results_filename, serve_dir):
    """Write the report of ``results_filename`` as ``serve_dir``'s
    ``index.html``; returns its path."""
    html = os.path.join(serve_dir, 'index.html')
    visualize.create_solutions_visualization(results_filename, html)
    return html


def serve(serve_dir, port):
    """Serve ``serve_dir`` at http://localhost:``port``/ until interrupted."""
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=serve_dir)
    with http.server.HTTPServer(('localhost', port), handler) as server:
        server.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('results', help='results store')
    ap.add_argument('--port', type=int, default=8000)
    args = ap.parse_args(argv)

    serve_dir = tempfile.mkdtemp(prefix='remixt_viewer_')
    html = build(args.results, serve_dir)
    print('serving {} at http://localhost:{}/'.format(html, args.port))
    serve(serve_dir, args.port)


if __name__ == '__main__':
    main()
