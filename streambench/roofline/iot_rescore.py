"""The bytes that a chunk of ``iot_rescore`` must move on the card
(see ``roofline/iot_alerts.py``): ``anomaly_score`` reads a temperature
and a device id and writes a score, 12 bytes a scored row, every row of
the chunk."""


def anomaly_score_bytes(rows: int) -> int:
    return 12 * rows
