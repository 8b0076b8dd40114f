"""One rank of ``bpvo_tpu_torch.parallel.worker`` whose ``Reducer`` takes
the peer route through its plain version: ``peer.attach`` returns a
``peer.PlainPeer`` (an all-gather of the ranks' buffers, then the fold in
rank order, bit for bit what ``csrc/peer_reduce.cu`` computes) for any
group of several ranks, gloo on the CPU included.  Run by
tests/test_torch_peer.py through ``multihost.launch`` with this directory
on PYTHONPATH; takes the worker's arguments and prints
``PLAIN_FOLDS <n>`` after the worker's line."""
from bpvo_tpu_torch.parallel import peer, worker

_made = []


def _attach(reducer):
    if reducer.world == 1:
        return None
    reducer.peer_rule = "the plain version (tests)"
    _made.append(peer.PlainPeer(reducer.group, reducer.world))
    return _made[-1]


if __name__ == "__main__":
    peer.attach = _attach
    worker.main()
    print(f"PLAIN_FOLDS {sum(p.folds for p in _made)}", flush=True)
