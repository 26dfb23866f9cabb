"""repro_torch.utils — the cost model of the port.

``hlo_analyzer`` — the op-trace cost analyzer: one eager run recorded op by
                   op (FLOPs of the products, operand plus result bytes,
                   collectives by scope, the live bytes' peak).
``roofline``     — the H100's roofline terms over such a trace, and the
                   reference's ``model_flops_estimate``.
"""
