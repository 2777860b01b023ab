"""exp5's corpus: Alibaba MSCallGraph-shaped call graphs from the clean
synthesizer (:func:`twbench.generator.synthesize`, no defect injection),
written as Jaeger JSON, one directory a call graph."""

from twbench import generator

#: configuration keys this step reads
KEYS = ("corpus_seed", "base_gap_ms", "n_services")


def write(root, counts, seed, config):
    return generator.synthesize(root, counts, seed,
                                corpus_seed=int(config["corpus_seed"]),
                                base_gap_ms=int(config["base_gap_ms"]),
                                n_services=int(config["n_services"]))
