"""Traffic drivers, one module a driver, found by the name a traffic mix
gives (traffic/<mix>.json "driver"): drivers/<driver>.py."""
