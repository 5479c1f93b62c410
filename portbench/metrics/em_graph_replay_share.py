"""EM loop: the share of ``hmm.em_step``'s fused-route calls on the card in
this process that a CUDA graph's replay served, in percent
(``em_step.replays`` over ``em_step.graph_calls``).  None where no call took
that path, or where the program keeps no such counters: traced runs lay
this benchmark over older trees too."""


def read(ctx):
    from multimodalworddiscovery_tpu_torch.models import hmm

    calls = getattr(hmm.em_step, "graph_calls", None)
    replays = getattr(hmm.em_step, "replays", None)
    if not calls or replays is None:
        return None
    return 100.0 * replays / calls
