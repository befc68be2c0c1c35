"""Host synchronizations per served cloud: ``cudaStreamSynchronize``,
``cudaDeviceSynchronize`` and blocking ``cudaMemcpy`` calls in the trace,
as ``serving_syncs.py`` counts them, less the benchmark's own
synchronize that closes the traced part."""

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def read(window, ctx):
    if window["kind"] != "serve" or not window["steps"]:
        return None
    syncs = window["trace"].count_host(SYNC_CALLS) - 1
    return syncs / window["steps"]
