"""The texture-recovery entry points of the port (ports of the JAX
package's apps/): `example` (texture recovery under an environment map),
`lightstage` (joint recovery over light patterns) and `fd_validate` (the
finite-difference vs autograd protocol). Each runs as

    python -m zdr_tpu_torch.apps.<name> [--device cuda|cpu] ...

on the card unless --device cpu asks for the plain versions, and each
`main(argv=None)` takes the command line's arguments as a list.
"""
