"""Model-side code of the port: the dense transformer (``common``,
``attention``, ``transformer``), the MoE dispatch-bitmap helpers
(``moe``) and the dispatch-bitmap size study (``moe_dispatch``)."""
