from repro_torch.data import federated, genomic, pca, tasks, tokenizer, tweets  # noqa: F401
