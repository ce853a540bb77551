"""The ported examples (``examples/`` of the JAX package, line for line).

Run one as a script from a checkout, e.g.
``python tpuframe_torch/examples/05_ray_fashion_mnist.py
--simulate-devices 1`` on the CPU, or without the flag on the card.  The
package makes them importable by module name too (``importlib.
import_module("tpuframe_torch.examples.01_distributor_cifar_resnet")``),
so that a launcher's worker can find their functions.
"""
