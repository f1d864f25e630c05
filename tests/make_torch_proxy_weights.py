"""Write the port's Inception-Score proxy weights from the JAX package's.

    JAX_PLATFORMS=cpu python tests/make_torch_proxy_weights.py

The JAX proxy classifier draws its weights with a flax init from
``jax.random.key(1234)`` (``fmri_tpu/metrics/inception.py:71``), which torch
cannot draw. This script runs that init on the CPU and writes the values in
the port's layout (``fmri_tpu_torch/metrics/inception.py::ProxyClassifier``:
conv kernels HWIO -> OIHW, the dense kernel transposed) to
``fmri_tpu_torch/metrics/proxy_classifier.npz``, the file the port loads.
``tests/test_torch_inception.py`` holds the committed file equal to it, bit
for bit.
"""

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "fmri_tpu_torch", "metrics", "proxy_classifier.npz")


def proxy_state() -> dict:
    """The JAX proxy's init as the port's ``state_dict`` (numpy fp32)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from fmri_tpu.metrics.inception import ProxyClassifier

    p = ProxyClassifier().init(jax.random.key(1234), jnp.zeros((1, 75, 75, 3)))["params"]
    sd = {}
    for i in range(3):
        conv = p[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1))
        sd[f"convs.{i}.bias"] = np.asarray(conv["bias"])
    sd["fc.weight"] = np.asarray(p["Dense_0"]["kernel"]).T
    sd["fc.bias"] = np.asarray(p["Dense_0"]["bias"])
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def main() -> None:
    sd = proxy_state()
    np.savez(OUT, **sd)
    print(f"wrote {OUT}: {sum(v.size for v in sd.values())} fp32 values")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, REPO)
    main()
