"""The yardstick: cells by name, the card, seeded weights, work counts, spans, the checks."""
