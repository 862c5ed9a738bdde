"""RA001 fixture: host syncs in the function a @one_executable_per getter
returns (a chunk) and in the pair a make_* factory returns."""
import torch

from repro_torch.analysis.contracts import one_executable_per


class Engine:
    def __init__(self):
        self._fns = {}

    @one_executable_per("width")
    def _get_chunk(self, width):
        def chunk(values, psd, it0, it_end):
            for _ in range(it0, it_end):
                # each one makes the host wait for the device per superstep
                hottest = psd.argmax().item()
                rows = psd.topk(width).indices.cpu()
                values[rows.tolist()] += hottest
            return values

        self._fns[width] = chunk
        return chunk


def make_sweeps(dev):
    def hot_sweep(values):
        # a device tensor made from a host value: a blocking copy
        cap = torch.tensor(float("inf"), device=dev)
        return torch.minimum(values, cap)

    def cold_sweep(values, psd):
        torch.cuda.synchronize()
        return values + float(psd)  # float() on a parameter

    return hot_sweep, cold_sweep
