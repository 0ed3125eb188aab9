"""Logical-axis rules and tensor-parallel compute over the ``model`` axis
(port of ``repro/sharding``): ``rules`` holds the rule table and the plan
of which elements each model rank computes on, ``tensor_parallel`` the
model group's conjugate collectives that the model code calls."""
