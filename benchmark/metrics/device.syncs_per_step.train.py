"""Host synchronizations per training step: ``cudaStreamSynchronize``,
``cudaDeviceSynchronize`` and blocking ``cudaMemcpy`` calls in the
trace, as ``serving_syncs.py`` counts them, less the benchmark's own
synchronize that closes the window."""

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def read(window, ctx):
    if window["kind"] != "train" or not window["steps"]:
        return None
    syncs = window["trace"].count_host(SYNC_CALLS) - 1
    return syncs / window["steps"]
