"""The backward's self device ms a step: the `backward` span's interval
less its children's (the compact-demand read, K3, K4, the chain), i.e.
autograd's backward of the loss, the assembly and the preprocess, the
part that has no kernel of its own; skipped steps count 0."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ["backward"], "self_device_ms")
