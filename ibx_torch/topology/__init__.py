"""Host topology compile (numpy) and the device tables it feeds."""
