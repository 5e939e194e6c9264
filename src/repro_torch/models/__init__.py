"""Model-side code of the port: so far the MoE dispatch-bitmap helpers
(``moe``) and the dispatch-bitmap size study (``moe_dispatch``)."""
