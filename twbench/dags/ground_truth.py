"""Each service's invocation DAG from its ground-truth assignments, which
the trace ids give: the program's ``infer_invocation_dag``, as exp5's
script builds it. Reads no configuration key and does not use the
device."""


def infer(problem, store, truth, device, config):
    from traceweaver_tpu_torch.ingest import infer_invocation_dag

    return infer_invocation_dag(problem.in_span_partitions, problem.out_span_partitions,
                                truth, store)
