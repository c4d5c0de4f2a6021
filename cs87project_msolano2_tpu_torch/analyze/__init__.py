"""Analysis of the port's records (the reference's ``analyze/``
package).  Only ``records`` is ported so far: the schema'd emission of
the bench's one JSON line and its environment fingerprint."""
