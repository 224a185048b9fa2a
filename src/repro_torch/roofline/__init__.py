"""The dry run's roofline (the port's ``repro/roofline``): ``analysis``
holds the reference's terms and formulas, ``count`` the port's count of a
step on ``meta`` tensors that stands in for XLA's cost analysis."""
