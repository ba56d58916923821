"""Operators of the port. Importing the package registers the kernels'
operators (``torch.ops.pvnet_torch.*``: K1, K2 in select_kernel, K3 in
voting, EPnP and the LM in pnp), which a process must do before it loads an
exported program that holds them."""
from pvnet_tpu_torch.ops import pnp, select_kernel, voting  # noqa: F401
