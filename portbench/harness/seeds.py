"""Seeds of the inputs: every random input of a run is drawn from the run's
``--seed`` and the input's own key, so one seed gives the same inputs."""

import hashlib


def sub_seed(seed, *key):
    """A 63-bit seed for the input named ``key`` of a run seeded ``seed``
    (any whole number)."""
    digest = hashlib.sha256(repr((int(seed),) + key).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(torch, device, seed, *key):
    """A ``torch.Generator`` on ``device`` seeded for the input ``key``."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *key))
