"""One reader a metric: ``benchmark/metrics/<metric>.py`` holds
``read(run) -> float | None``, where ``run`` has the configuration
(``cfg``), the traffic mix (``traffic``), the window's record (``record``),
the traced segments merged (``trace``, None without ``--trace 1``), the
set-up time (``setup_s``) and the device.  None: nothing to read, and the
harness leaves the metric out.  A share of a roofline or of a peak is never
0 for want of a reading, and never clipped."""
