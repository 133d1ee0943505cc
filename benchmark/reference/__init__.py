"""The benchmark's plain reference and its frozen copies.

Plain NumPy and PyTorch only: nothing here imports the measured package
(``geneo4petsc_tpu_torch``), JAX or the JAX package, and nothing here
takes anything the measured package made.

* ``fields/<kind>.py`` — the coefficient-field generators, frozen
  copies of the upstream generators' arithmetic (each module's
  docstring names its source);
* ``kappa_7point.py`` — the 7-point operator derived from a kappa field
  by the upstream generator's element formula, and the residual that
  decides ``correct``;
* ``roofline.py`` — the card's published peaks and the roofline bound
  of the stencil product.
"""
