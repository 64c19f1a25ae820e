"""CUDA-graph captures outside ``GraphSpace.capture``: a capture there
is a build nobody counts, so ``*_retraces_after_warmup`` would miss it
and its keys would go unchecked (``graph-keys``)."""
import torch


class GraphSpace:
    def capture(self, run):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = run()
        return graph, outs


class SideSteps:
    def build(self, run):
        graph = torch.cuda.CUDAGraph()  # EXPECT: graph-keys
        with torch.cuda.graph(graph):  # EXPECT: graph-keys
            return graph, run()


def capture(run):
    # a free function named like the method is no counted build either
    g = torch.cuda.CUDAGraph()  # EXPECT: graph-keys
    with torch.cuda.graph(g):  # EXPECT: graph-keys
        run()
    return g
