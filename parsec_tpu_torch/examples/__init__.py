"""The tutorial series, ported: ``ex00`` … ``ex14`` and ``dtd/``.

Each example is a module with ``main(device=None, ...)``: it runs on the
card unless the caller passes ``device="cpu"`` (the torch CPU device, as
the tests run it), prints the same self-check lines as the JAX package's
``examples/`` script of the same name, and returns a dict of the results
it checked.  Sizes are keyword arguments whose defaults are the JAX
examples' sizes.  ``python -m parsec_tpu_torch.examples.ex01_helloworld``
runs one on the card, ``--cpu`` on the torch CPU device.  The ``.jdf``
programs under ``jdf/`` ship with the package (README.md lists them all).
"""
