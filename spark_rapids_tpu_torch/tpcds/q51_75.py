"""TPC-DS queries 51-75 as SQL text.

Copied from ``spark_rapids_tpu/tpcds/q51_75.py``.
"""

Q = {}

Q[51] = """
with web_v1 as (
  select ws_item_sk item_sk, d_date,
         sum(sum(ws_sales_price))
           over (partition by ws_item_sk order by d_date
                 rows between unbounded preceding and current row) cume_sales
  from web_sales, date_dim
  where ws_sold_date_sk = d_date_sk and d_month_seq between 360 and 360 + 11
    and ws_item_sk is not null
  group by ws_item_sk, d_date),
 store_v1 as (
  select ss_item_sk item_sk, d_date,
         sum(sum(ss_sales_price))
           over (partition by ss_item_sk order by d_date
                 rows between unbounded preceding and current row) cume_sales
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk and d_month_seq between 360 and 360 + 11
    and ss_item_sk is not null
  group by ss_item_sk, d_date)
select *
from (select item_sk, d_date, web_sales, store_sales,
             max(web_sales) over (partition by item_sk order by d_date
                                  rows between unbounded preceding
                                           and current row) web_cumulative,
             max(store_sales) over (partition by item_sk order by d_date
                                    rows between unbounded preceding
                                             and current row) store_cumulative
      from (select case when web.item_sk is not null then web.item_sk
                        else store.item_sk end item_sk,
                   case when web.d_date is not null then web.d_date
                        else store.d_date end d_date,
                   web.cume_sales web_sales, store.cume_sales store_sales
            from web_v1 web full outer join store_v1 store
              on web.item_sk = store.item_sk and web.d_date = store.d_date
           ) x) y
where web_cumulative > store_cumulative
order by item_sk, d_date
limit 100
"""

Q[52] = """
select d_year, i_brand_id brand_id, i_brand brand, sum(ss_ext_sales_price) ext_price
from date_dim dt, store_sales, item
where dt.d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 1 and dt.d_moy = 11 and dt.d_year = 2000
group by d_year, i_brand, i_brand_id
order by d_year, ext_price desc, brand_id
limit 100
"""

Q[53] = """
select *
from (select i_manufact_id, sum(ss_sales_price) sum_sales,
             avg(sum(ss_sales_price))
               over (partition by i_manufact_id) avg_quarterly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and d_month_seq in (360, 361, 362, 363, 364, 365, 366, 367, 368,
                            369, 370, 371)
        and ((i_category in ('Books', 'Children', 'Electronics')
              and i_class in ('booksclass1', 'childrenclass2',
                              'electronicsclass3'))
          or (i_category in ('Women', 'Music', 'Men')
              and i_class in ('womenclass1', 'musicclass2', 'menclass4')))
      group by i_manufact_id, d_qoy) tmp1
where case when avg_quarterly_sales > 0
           then abs(sum_sales - avg_quarterly_sales) / avg_quarterly_sales
           else null end > 0.1
order by avg_quarterly_sales, sum_sales, i_manufact_id
limit 100
"""

Q[54] = """
with my_customers as (
  select distinct c_customer_sk, c_current_addr_sk
  from (select cs_sold_date_sk sold_date_sk, cs_bill_customer_sk customer_sk,
               cs_item_sk item_sk
        from catalog_sales
        union all
        select ws_sold_date_sk sold_date_sk, ws_bill_customer_sk customer_sk,
               ws_item_sk item_sk
        from web_sales) cs_or_ws_sales,
       item, date_dim, customer
  where sold_date_sk = d_date_sk and item_sk = i_item_sk
    and i_category = 'Women' and i_class like '%class%'
    and c_customer_sk = cs_or_ws_sales.customer_sk
    and d_moy = 12 and d_year = 1998),
 my_revenue as (
  select c_customer_sk, sum(ss_ext_sales_price) as revenue
  from my_customers, store_sales, customer_address, store, date_dim
  where c_current_addr_sk = ca_address_sk
    and ca_county = s_county and ca_state = s_state
    and ss_sold_date_sk = d_date_sk and c_customer_sk = ss_customer_sk
    and d_month_seq between (select distinct d_month_seq + 1 from date_dim
                             where d_year = 1998 and d_moy = 12)
                        and (select distinct d_month_seq + 3 from date_dim
                             where d_year = 1998 and d_moy = 12)
  group by c_customer_sk),
 segments as (
  select cast((revenue / 50) as int) as segment from my_revenue)
select segment, count(*) as num_customers, segment * 50 as segment_base
from segments
group by segment
order by segment, num_customers
limit 100
"""

Q[55] = """
select i_brand_id brand_id, i_brand brand, sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 28 and d_moy = 11 and d_year = 1999
group by i_brand, i_brand_id
order by ext_price desc, brand_id
limit 100
"""

Q[56] = """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) total_sales
  from store_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_color in ('slate', 'blanched', 'burnished',
                                        'red', 'blue', 'green'))
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2 and ss_addr_sk = ca_address_sk
    and ca_gmt_offset = -5.0
  group by i_item_id),
 cs as (
  select i_item_id, sum(cs_ext_sales_price) total_sales
  from catalog_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_color in ('slate', 'blanched', 'burnished',
                                        'red', 'blue', 'green'))
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2 and cs_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5.0
  group by i_item_id),
 ws as (
  select i_item_id, sum(ws_ext_sales_price) total_sales
  from web_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_color in ('slate', 'blanched', 'burnished',
                                        'red', 'blue', 'green'))
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2 and ws_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5.0
  group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select * from ss
      union all
      select * from cs
      union all
      select * from ws) tmp1
group by i_item_id
order by total_sales, i_item_id
limit 100
"""

Q[57] = """
with v1 as (
  select i_category, i_brand, cc_name, d_year, d_moy,
         sum(cs_sales_price) sum_sales,
         avg(sum(cs_sales_price))
           over (partition by i_category, i_brand, cc_name, d_year)
           avg_monthly_sales,
         rank() over (partition by i_category, i_brand, cc_name
                      order by d_year, d_moy) rn
  from item, catalog_sales, date_dim, call_center
  where cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and cc_call_center_sk = cs_call_center_sk
    and (d_year = 1999 or (d_year = 1998 and d_moy = 12)
         or (d_year = 2000 and d_moy = 1))
  group by i_category, i_brand, cc_name, d_year, d_moy),
 v2 as (
  select v1.i_category, v1.i_brand, v1.cc_name, v1.d_year, v1.d_moy,
         v1.avg_monthly_sales, v1.sum_sales, v1_lag.sum_sales psum,
         v1_lead.sum_sales nsum
  from v1, v1 v1_lag, v1 v1_lead
  where v1.i_category = v1_lag.i_category
    and v1.i_category = v1_lead.i_category
    and v1.i_brand = v1_lag.i_brand and v1.i_brand = v1_lead.i_brand
    and v1.cc_name = v1_lag.cc_name and v1.cc_name = v1_lead.cc_name
    and v1.rn = v1_lag.rn + 1 and v1.rn = v1_lead.rn - 1)
select *
from v2
where d_year = 1999 and avg_monthly_sales > 0
  and case when avg_monthly_sales > 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by sum_sales - avg_monthly_sales, 3
limit 100
"""

Q[58] = """
with ss_items as (
  select i_item_id item_id, sum(ss_ext_sales_price) ss_item_rev
  from store_sales, item, date_dim
  where ss_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq = (select d_week_seq from date_dim
                                       where d_date = date '2000-01-03'))
    and ss_sold_date_sk = d_date_sk
  group by i_item_id),
 cs_items as (
  select i_item_id item_id, sum(cs_ext_sales_price) cs_item_rev
  from catalog_sales, item, date_dim
  where cs_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq = (select d_week_seq from date_dim
                                       where d_date = date '2000-01-03'))
    and cs_sold_date_sk = d_date_sk
  group by i_item_id),
 ws_items as (
  select i_item_id item_id, sum(ws_ext_sales_price) ws_item_rev
  from web_sales, item, date_dim
  where ws_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq = (select d_week_seq from date_dim
                                       where d_date = date '2000-01-03'))
    and ws_sold_date_sk = d_date_sk
  group by i_item_id)
select ss_items.item_id, ss_item_rev,
       ss_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
         ss_dev,
       cs_item_rev,
       cs_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
         cs_dev,
       ws_item_rev,
       ws_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
         ws_dev,
       (ss_item_rev + cs_item_rev + ws_item_rev) / 3 average
from ss_items, cs_items, ws_items
where ss_items.item_id = cs_items.item_id
  and ss_items.item_id = ws_items.item_id
  and ss_item_rev between 0.9 * cs_item_rev and 1.1 * cs_item_rev
  and ss_item_rev between 0.9 * ws_item_rev and 1.1 * ws_item_rev
  and cs_item_rev between 0.9 * ss_item_rev and 1.1 * ss_item_rev
  and cs_item_rev between 0.9 * ws_item_rev and 1.1 * ws_item_rev
  and ws_item_rev between 0.9 * ss_item_rev and 1.1 * ss_item_rev
  and ws_item_rev between 0.9 * cs_item_rev and 1.1 * cs_item_rev
order by item_id, ss_item_rev
limit 100
"""

Q[59] = """
with wss as (
  select d_week_seq, ss_store_sk,
         sum(case when d_day_name = 'Sunday' then ss_sales_price
                  else null end) sun_sales,
         sum(case when d_day_name = 'Monday' then ss_sales_price
                  else null end) mon_sales,
         sum(case when d_day_name = 'Tuesday' then ss_sales_price
                  else null end) tue_sales,
         sum(case when d_day_name = 'Wednesday' then ss_sales_price
                  else null end) wed_sales,
         sum(case when d_day_name = 'Thursday' then ss_sales_price
                  else null end) thu_sales,
         sum(case when d_day_name = 'Friday' then ss_sales_price
                  else null end) fri_sales,
         sum(case when d_day_name = 'Saturday' then ss_sales_price
                  else null end) sat_sales
  from store_sales, date_dim
  where d_date_sk = ss_sold_date_sk
  group by d_week_seq, ss_store_sk)
select s_store_name1, s_store_id1, d_week_seq1,
       sun_sales1 / sun_sales2, mon_sales1 / mon_sales2,
       tue_sales1 / tue_sales2, wed_sales1 / wed_sales2,
       thu_sales1 / thu_sales2, fri_sales1 / fri_sales2,
       sat_sales1 / sat_sales2
from (select s_store_name s_store_name1, wss.d_week_seq d_week_seq1,
             s_store_id s_store_id1, sun_sales sun_sales1,
             mon_sales mon_sales1, tue_sales tue_sales1,
             wed_sales wed_sales1, thu_sales thu_sales1,
             fri_sales fri_sales1, sat_sales sat_sales1
      from wss, store, date_dim d
      where d.d_week_seq = wss.d_week_seq and ss_store_sk = s_store_sk
        and d_month_seq between 360 and 360 + 11) y,
     (select s_store_name s_store_name2, wss.d_week_seq d_week_seq2,
             s_store_id s_store_id2, sun_sales sun_sales2,
             mon_sales mon_sales2, tue_sales tue_sales2,
             wed_sales wed_sales2, thu_sales thu_sales2,
             fri_sales fri_sales2, sat_sales sat_sales2
      from wss, store, date_dim d
      where d.d_week_seq = wss.d_week_seq and ss_store_sk = s_store_sk
        and d_month_seq between 360 + 12 and 360 + 23) x
where s_store_id1 = s_store_id2 and d_week_seq1 = d_week_seq2 - 52
order by s_store_name1, s_store_id1, d_week_seq1
limit 100
"""

Q[60] = """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) total_sales
  from store_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item where i_category = 'Music')
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 9 and ss_addr_sk = ca_address_sk
    and ca_gmt_offset = -5.0
  group by i_item_id),
 cs as (
  select i_item_id, sum(cs_ext_sales_price) total_sales
  from catalog_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item where i_category = 'Music')
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 9 and cs_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5.0
  group by i_item_id),
 ws as (
  select i_item_id, sum(ws_ext_sales_price) total_sales
  from web_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item where i_category = 'Music')
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 9 and ws_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5.0
  group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select * from ss
      union all
      select * from cs
      union all
      select * from ws) tmp1
group by i_item_id
order by i_item_id, total_sales
limit 100
"""

Q[61] = """
select promotions, total,
       cast(promotions as double) / cast(total as double) * 100
from (select sum(ss_ext_sales_price) promotions
      from store_sales, store, promotion, date_dim, customer,
           customer_address, item
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_promo_sk = p_promo_sk and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5.0 and i_category = 'Jewelry'
        and (p_channel_dmail = 'Y' or p_channel_email = 'Y'
             or p_channel_tv = 'Y')
        and s_gmt_offset = -5.0 and d_year = 1998 and d_moy = 11) promotional_sales,
     (select sum(ss_ext_sales_price) total
      from store_sales, store, date_dim, customer, customer_address, item
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5.0 and i_category = 'Jewelry'
        and s_gmt_offset = -5.0 and d_year = 1998 and d_moy = 11) all_sales
order by promotions, total
limit 100
"""

Q[62] = """
select substr(w_warehouse_name, 1, 20), sm_type, web_name,
       sum(case when ws_ship_date_sk - ws_sold_date_sk <= 30
                then 1 else 0 end) as days30,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 30
                 and ws_ship_date_sk - ws_sold_date_sk <= 60
                then 1 else 0 end) as days60,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 60
                 and ws_ship_date_sk - ws_sold_date_sk <= 90
                then 1 else 0 end) as days90,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 90
                 and ws_ship_date_sk - ws_sold_date_sk <= 120
                then 1 else 0 end) as days120,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 120
                then 1 else 0 end) as days_more_120
from web_sales, warehouse, ship_mode, web_site, date_dim
where d_month_seq between 360 and 360 + 11
  and ws_ship_date_sk = d_date_sk and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk and ws_web_site_sk = web_site_sk
group by substr(w_warehouse_name, 1, 20), sm_type, web_name
order by substr(w_warehouse_name, 1, 20), sm_type, web_name
limit 100
"""

Q[63] = """
select *
from (select i_manager_id, sum(ss_sales_price) sum_sales,
             avg(sum(ss_sales_price))
               over (partition by i_manager_id) avg_monthly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and d_month_seq in (360, 361, 362, 363, 364, 365, 366, 367, 368,
                            369, 370, 371)
        and ((i_category in ('Books', 'Children', 'Electronics')
              and i_class in ('booksclass1', 'childrenclass2',
                              'electronicsclass3'))
          or (i_category in ('Women', 'Music', 'Men')
              and i_class in ('womenclass1', 'musicclass2', 'menclass4')))
      group by i_manager_id, d_moy) tmp1
where case when avg_monthly_sales > 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by i_manager_id, avg_monthly_sales, sum_sales
limit 100
"""

Q[64] = """
with cs_ui as (
  select cs_item_sk,
         sum(cs_ext_list_price) as sale,
         sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit) as refund
  from catalog_sales, catalog_returns
  where cs_item_sk = cr_item_sk and cs_order_number = cr_order_number
  group by cs_item_sk
  having sum(cs_ext_list_price)
           > 2 * sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)),
 cross_sales as (
  select i_product_name product_name, i_item_sk item_sk,
         s_store_name store_name, s_zip store_zip,
         ad1.ca_street_number b_street_number,
         ad1.ca_street_name b_street_name, ad1.ca_city b_city,
         ad1.ca_zip b_zip, ad2.ca_street_number c_street_number,
         ad2.ca_street_name c_street_name, ad2.ca_city c_city,
         ad2.ca_zip c_zip, d1.d_year as syear, d2.d_year as fsyear,
         d3.d_year s2year, count(*) cnt,
         sum(ss_wholesale_cost) s1, sum(ss_list_price) s2,
         sum(ss_coupon_amt) s3
  from store_sales, store_returns, cs_ui, date_dim d1, date_dim d2,
       date_dim d3, store, customer, customer_demographics cd1,
       customer_demographics cd2, promotion, household_demographics hd1,
       household_demographics hd2, customer_address ad1,
       customer_address ad2, income_band ib1, income_band ib2, item
  where ss_store_sk = s_store_sk and ss_sold_date_sk = d1.d_date_sk
    and ss_customer_sk = c_customer_sk and ss_cdemo_sk = cd1.cd_demo_sk
    and ss_hdemo_sk = hd1.hd_demo_sk and ss_addr_sk = ad1.ca_address_sk
    and ss_item_sk = i_item_sk and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and ss_item_sk = cs_ui.cs_item_sk
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_hdemo_sk = hd2.hd_demo_sk
    and c_current_addr_sk = ad2.ca_address_sk
    and c_first_sales_date_sk = d2.d_date_sk
    and c_first_shipto_date_sk = d3.d_date_sk
    and ss_promo_sk = p_promo_sk
    and hd1.hd_income_band_sk = ib1.ib_income_band_sk
    and hd2.hd_income_band_sk = ib2.ib_income_band_sk
    and cd1.cd_marital_status <> cd2.cd_marital_status
    and i_color in ('purple', 'burlywood', 'indian', 'spring',
                    'floral', 'medium')
    and i_current_price between 64 and 64 + 10
    and i_current_price between 64 + 1 and 64 + 15
  group by i_product_name, i_item_sk, s_store_name, s_zip,
           ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city, ad1.ca_zip,
           ad2.ca_street_number, ad2.ca_street_name, ad2.ca_city, ad2.ca_zip,
           d1.d_year, d2.d_year, d3.d_year)
select cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
       cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
       cs1.syear, cs1.cnt, cs1.s1 as s11, cs1.s2 as s21, cs1.s3 as s31,
       cs2.s1 as s12, cs2.s2 as s22, cs2.s3 as s32, cs2.syear as syear2,
       cs2.cnt as cnt2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk and cs1.syear = 1999
  and cs2.syear = 1999 + 1 and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cnt2, s12, s22, s32
"""

Q[65] = """
select s_store_name, i_item_desc, sc.revenue, i_current_price,
       i_wholesale_cost, i_brand
from store, item,
     (select ss_store_sk, avg(revenue) as ave
      from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
            from store_sales, date_dim
            where ss_sold_date_sk = d_date_sk
              and d_month_seq between 360 and 360 + 11
            group by ss_store_sk, ss_item_sk) sa
      group by ss_store_sk) sb,
     (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
      from store_sales, date_dim
      where ss_sold_date_sk = d_date_sk
        and d_month_seq between 360 and 360 + 11
      group by ss_store_sk, ss_item_sk) sc
where sb.ss_store_sk = sc.ss_store_sk and sc.revenue <= 0.1 * sb.ave
  and s_store_sk = sc.ss_store_sk and i_item_sk = sc.ss_item_sk
order by s_store_name, i_item_desc, sc.revenue
limit 100
"""

Q[66] = """
select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
       w_country, ship_carriers, year_,
       sum(jan_sales) as jan_sales, sum(feb_sales) as feb_sales,
       sum(mar_sales) as mar_sales, sum(apr_sales) as apr_sales,
       sum(may_sales) as may_sales, sum(jun_sales) as jun_sales,
       sum(jul_sales) as jul_sales, sum(aug_sales) as aug_sales,
       sum(sep_sales) as sep_sales, sum(oct_sales) as oct_sales,
       sum(nov_sales) as nov_sales, sum(dec_sales) as dec_sales,
       sum(jan_net) as jan_net, sum(feb_net) as feb_net,
       sum(mar_net) as mar_net, sum(apr_net) as apr_net,
       sum(may_net) as may_net, sum(jun_net) as jun_net,
       sum(jul_net) as jul_net, sum(aug_net) as aug_net,
       sum(sep_net) as sep_net, sum(oct_net) as oct_net,
       sum(nov_net) as nov_net, sum(dec_net) as dec_net
from (select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
             w_state, w_country,
             'DHL' || ',' || 'BARIAN' as ship_carriers, d_year as year_,
             sum(case when d_moy = 1 then ws_ext_sales_price * ws_quantity
                      else 0 end) as jan_sales,
             sum(case when d_moy = 2 then ws_ext_sales_price * ws_quantity
                      else 0 end) as feb_sales,
             sum(case when d_moy = 3 then ws_ext_sales_price * ws_quantity
                      else 0 end) as mar_sales,
             sum(case when d_moy = 4 then ws_ext_sales_price * ws_quantity
                      else 0 end) as apr_sales,
             sum(case when d_moy = 5 then ws_ext_sales_price * ws_quantity
                      else 0 end) as may_sales,
             sum(case when d_moy = 6 then ws_ext_sales_price * ws_quantity
                      else 0 end) as jun_sales,
             sum(case when d_moy = 7 then ws_ext_sales_price * ws_quantity
                      else 0 end) as jul_sales,
             sum(case when d_moy = 8 then ws_ext_sales_price * ws_quantity
                      else 0 end) as aug_sales,
             sum(case when d_moy = 9 then ws_ext_sales_price * ws_quantity
                      else 0 end) as sep_sales,
             sum(case when d_moy = 10 then ws_ext_sales_price * ws_quantity
                      else 0 end) as oct_sales,
             sum(case when d_moy = 11 then ws_ext_sales_price * ws_quantity
                      else 0 end) as nov_sales,
             sum(case when d_moy = 12 then ws_ext_sales_price * ws_quantity
                      else 0 end) as dec_sales,
             sum(case when d_moy = 1 then ws_net_paid * ws_quantity
                      else 0 end) as jan_net,
             sum(case when d_moy = 2 then ws_net_paid * ws_quantity
                      else 0 end) as feb_net,
             sum(case when d_moy = 3 then ws_net_paid * ws_quantity
                      else 0 end) as mar_net,
             sum(case when d_moy = 4 then ws_net_paid * ws_quantity
                      else 0 end) as apr_net,
             sum(case when d_moy = 5 then ws_net_paid * ws_quantity
                      else 0 end) as may_net,
             sum(case when d_moy = 6 then ws_net_paid * ws_quantity
                      else 0 end) as jun_net,
             sum(case when d_moy = 7 then ws_net_paid * ws_quantity
                      else 0 end) as jul_net,
             sum(case when d_moy = 8 then ws_net_paid * ws_quantity
                      else 0 end) as aug_net,
             sum(case when d_moy = 9 then ws_net_paid * ws_quantity
                      else 0 end) as sep_net,
             sum(case when d_moy = 10 then ws_net_paid * ws_quantity
                      else 0 end) as oct_net,
             sum(case when d_moy = 11 then ws_net_paid * ws_quantity
                      else 0 end) as nov_net,
             sum(case when d_moy = 12 then ws_net_paid * ws_quantity
                      else 0 end) as dec_net
      from web_sales, warehouse, date_dim, time_dim, ship_mode
      where ws_warehouse_sk = w_warehouse_sk and ws_sold_date_sk = d_date_sk
        and ws_sold_time_sk = t_time_sk and ws_ship_mode_sk = sm_ship_mode_sk
        and d_year = 2001 and t_time between 30838 and 30838 + 28800
        and sm_carrier in ('DHL', 'BARIAN')
      group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
               w_state, w_country, d_year
      union all
      select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
             w_state, w_country,
             'DHL' || ',' || 'BARIAN' as ship_carriers, d_year as year_,
             sum(case when d_moy = 1 then cs_sales_price * cs_quantity
                      else 0 end) as jan_sales,
             sum(case when d_moy = 2 then cs_sales_price * cs_quantity
                      else 0 end) as feb_sales,
             sum(case when d_moy = 3 then cs_sales_price * cs_quantity
                      else 0 end) as mar_sales,
             sum(case when d_moy = 4 then cs_sales_price * cs_quantity
                      else 0 end) as apr_sales,
             sum(case when d_moy = 5 then cs_sales_price * cs_quantity
                      else 0 end) as may_sales,
             sum(case when d_moy = 6 then cs_sales_price * cs_quantity
                      else 0 end) as jun_sales,
             sum(case when d_moy = 7 then cs_sales_price * cs_quantity
                      else 0 end) as jul_sales,
             sum(case when d_moy = 8 then cs_sales_price * cs_quantity
                      else 0 end) as aug_sales,
             sum(case when d_moy = 9 then cs_sales_price * cs_quantity
                      else 0 end) as sep_sales,
             sum(case when d_moy = 10 then cs_sales_price * cs_quantity
                      else 0 end) as oct_sales,
             sum(case when d_moy = 11 then cs_sales_price * cs_quantity
                      else 0 end) as nov_sales,
             sum(case when d_moy = 12 then cs_sales_price * cs_quantity
                      else 0 end) as dec_sales,
             sum(case when d_moy = 1 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as jan_net,
             sum(case when d_moy = 2 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as feb_net,
             sum(case when d_moy = 3 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as mar_net,
             sum(case when d_moy = 4 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as apr_net,
             sum(case when d_moy = 5 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as may_net,
             sum(case when d_moy = 6 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as jun_net,
             sum(case when d_moy = 7 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as jul_net,
             sum(case when d_moy = 8 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as aug_net,
             sum(case when d_moy = 9 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as sep_net,
             sum(case when d_moy = 10 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as oct_net,
             sum(case when d_moy = 11 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as nov_net,
             sum(case when d_moy = 12 then cs_net_paid_inc_tax * cs_quantity
                      else 0 end) as dec_net
      from catalog_sales, warehouse, date_dim, time_dim, ship_mode
      where cs_warehouse_sk = w_warehouse_sk and cs_sold_date_sk = d_date_sk
        and cs_sold_time_sk = t_time_sk and cs_ship_mode_sk = sm_ship_mode_sk
        and d_year = 2001 and t_time between 30838 and 30838 + 28800
        and sm_carrier in ('DHL', 'BARIAN')
      group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
               w_state, w_country, d_year) x
group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country, ship_carriers, year_
order by w_warehouse_name
limit 100
"""

Q[67] = """
select *
from (select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
             d_moy, s_store_id, sumsales,
             rank() over (partition by i_category
                          order by sumsales desc) rk
      from (select i_category, i_class, i_brand, i_product_name, d_year,
                   d_qoy, d_moy, s_store_id,
                   sum(coalesce(ss_sales_price * ss_quantity, 0)) sumsales
            from store_sales, date_dim, store, item
            where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
              and ss_store_sk = s_store_sk
              and d_month_seq between 360 and 360 + 11
            group by rollup (i_category, i_class, i_brand, i_product_name,
                             d_year, d_qoy, d_moy, s_store_id)) dw1) dw2
where rk <= 100
order by i_category nulls last, i_class nulls last, i_brand nulls last,
         i_product_name nulls last, d_year nulls last, d_qoy nulls last,
         d_moy nulls last, s_store_id nulls last, sumsales, rk
limit 100
"""

Q[68] = """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       extended_price, extended_tax, list_price
from (select ss_ticket_number, ss_customer_sk, ca_city bought_city,
             sum(ss_ext_sales_price) extended_price,
             sum(ss_ext_list_price) list_price,
             sum(ss_ext_tax) extended_tax
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
        and d_dom between 1 and 2 and d_year in (1999, 2000, 2001)
        and (hd_dep_count = 4 or hd_vehicle_count = 3)
        and s_city in ('Fairview', 'Midway')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, ss_ticket_number
limit 100
"""

Q[69] = """
select cd_gender, cd_marital_status, cd_education_status, count(*) cnt1,
       cd_purchase_estimate, count(*) cnt2, cd_credit_rating, count(*) cnt3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_state in ('KY', 'GA', 'NM')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk and d_year = 2001
                and d_moy between 4 and 4 + 2)
  and not exists (select * from web_sales, date_dim
                  where c.c_customer_sk = ws_bill_customer_sk
                    and ws_sold_date_sk = d_date_sk and d_year = 2001
                    and d_moy between 4 and 4 + 2)
  and not exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_ship_customer_sk
                    and cs_sold_date_sk = d_date_sk and d_year = 2001
                    and d_moy between 4 and 4 + 2)
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
limit 100
"""

Q[70] = """
select sum(ss_net_profit) as total_sum, s_state, s_county,
       grouping(s_state) + grouping(s_county) as lochierarchy,
       rank() over (partition by grouping(s_state) + grouping(s_county),
                    case when grouping(s_county) = 0 then s_state end
                    order by sum(ss_net_profit) desc) as rank_within_parent
from store_sales, date_dim d1, store
where d1.d_month_seq between 360 and 360 + 11
  and d1.d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
  and s_state in (select s_state
                  from (select s_state as s_state,
                               rank() over (partition by s_state
                                            order by sum(ss_net_profit) desc)
                                 ranking
                        from store_sales, store, date_dim
                        where d_month_seq between 360 and 360 + 11
                          and d_date_sk = ss_sold_date_sk
                          and s_store_sk = ss_store_sk
                        group by s_state) tmp1
                  where ranking <= 5)
group by rollup (s_state, s_county)
order by lochierarchy desc, case when lochierarchy = 0 then s_state end,
         rank_within_parent
limit 100
"""

Q[71] = """
select i_brand_id brand_id, i_brand brand, t_hour, t_minute,
       sum(ext_price) ext_price
from item,
     (select ws_ext_sales_price as ext_price,
             ws_sold_date_sk as sold_date_sk, ws_item_sk as sold_item_sk,
             ws_sold_time_sk as time_sk
      from web_sales, date_dim
      where d_date_sk = ws_sold_date_sk and d_moy = 11 and d_year = 1999
      union all
      select cs_ext_sales_price as ext_price,
             cs_sold_date_sk as sold_date_sk, cs_item_sk as sold_item_sk,
             cs_sold_time_sk as time_sk
      from catalog_sales, date_dim
      where d_date_sk = cs_sold_date_sk and d_moy = 11 and d_year = 1999
      union all
      select ss_ext_sales_price as ext_price,
             ss_sold_date_sk as sold_date_sk, ss_item_sk as sold_item_sk,
             ss_sold_time_sk as time_sk
      from store_sales, date_dim
      where d_date_sk = ss_sold_date_sk and d_moy = 11 and d_year = 1999
     ) tmp, time_dim
where sold_item_sk = i_item_sk and i_manager_id = 1
  and time_sk = t_time_sk
  and (t_meal_time = 'breakfast' or t_meal_time = 'dinner')
group by i_brand, i_brand_id, t_hour, t_minute
order by ext_price desc, brand_id
"""

Q[72] = """
select i_item_desc, w_warehouse_name, d1.d_week_seq,
       sum(case when p_promo_sk is null then 1 else 0 end) no_promo,
       sum(case when p_promo_sk is not null then 1 else 0 end) promo,
       count(*) total_cnt
from catalog_sales
     join inventory on (cs_item_sk = inv_item_sk)
     join warehouse on (w_warehouse_sk = inv_warehouse_sk)
     join item on (i_item_sk = cs_item_sk)
     join customer_demographics on (cs_bill_cdemo_sk = cd_demo_sk)
     join household_demographics on (cs_bill_hdemo_sk = hd_demo_sk)
     join date_dim d1 on (cs_sold_date_sk = d1.d_date_sk)
     join date_dim d2 on (inv_date_sk = d2.d_date_sk)
     join date_dim d3 on (cs_ship_date_sk = d3.d_date_sk)
     left outer join promotion on (cs_promo_sk = p_promo_sk)
     left outer join catalog_returns on (cr_item_sk = cs_item_sk
                                         and cr_order_number = cs_order_number)
where d1.d_week_seq = d2.d_week_seq and inv_quantity_on_hand < cs_quantity
  and d3.d_date > d1.d_date + interval '5' day
  and hd_buy_potential = '>10000' and d1.d_year = 1999
  and cd_marital_status = 'D'
group by i_item_desc, w_warehouse_name, d1.d_week_seq
order by total_cnt desc, i_item_desc, w_warehouse_name, d1.d_week_seq
limit 100
"""

Q[73] = """
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and d_dom between 1 and 2
        and (hd_buy_potential = '>10000' or hd_buy_potential = 'Unknown')
        and hd_vehicle_count > 0
        and case when hd_vehicle_count > 0
                 then cast(hd_dep_count as double) / hd_vehicle_count
                 else null end > 1
        and d_year in (1999, 2000, 2001)
        and s_county in ('Ziebach County', 'Williamson County',
                         'Walker County', 'Salem County')
      group by ss_ticket_number, ss_customer_sk) dj,
     customer
where ss_customer_sk = c_customer_sk and cnt between 1 and 5
order by cnt desc, c_last_name asc
"""

Q[74] = """
with year_total as (
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year as year_,
         sum(ss_net_paid) year_total, 's' sale_type
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
    and d_year in (2001, 2001 + 1)
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year as year_,
         sum(ws_net_paid) year_total, 'w' sale_type
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
    and d_year in (2001, 2001 + 1)
  group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_w_firstyear.sale_type = 'w'
  and t_s_secyear.sale_type = 's' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.year_ = 2001 and t_s_secyear.year_ = 2001 + 1
  and t_w_firstyear.year_ = 2001 and t_w_secyear.year_ = 2001 + 1
  and t_s_firstyear.year_total > 0 and t_w_firstyear.year_total > 0
  and case when t_w_firstyear.year_total > 0
           then t_w_secyear.year_total / t_w_firstyear.year_total
           else null end
        > case when t_s_firstyear.year_total > 0
               then t_s_secyear.year_total / t_s_firstyear.year_total
               else null end
order by 1, 1, 1
limit 100
"""

Q[75] = """
with all_sales as (
  select d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
         sum(sales_cnt) as sales_cnt, sum(sales_amt) as sales_amt
  from (select d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
               cs_quantity - coalesce(cr_return_quantity, 0) as sales_cnt,
               cs_ext_sales_price - coalesce(cr_return_amount, 0.0)
                 as sales_amt
        from catalog_sales
             join item on i_item_sk = cs_item_sk
             join date_dim on d_date_sk = cs_sold_date_sk
             left join catalog_returns on (cs_order_number = cr_order_number
                                           and cs_item_sk = cr_item_sk)
        where i_category = 'Books'
        union
        select d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
               ss_quantity - coalesce(sr_return_quantity, 0) as sales_cnt,
               ss_ext_sales_price - coalesce(sr_return_amt, 0.0) as sales_amt
        from store_sales
             join item on i_item_sk = ss_item_sk
             join date_dim on d_date_sk = ss_sold_date_sk
             left join store_returns on (ss_ticket_number = sr_ticket_number
                                         and ss_item_sk = sr_item_sk)
        where i_category = 'Books'
        union
        select d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
               ws_quantity - coalesce(wr_return_quantity, 0) as sales_cnt,
               ws_ext_sales_price - coalesce(wr_return_amt, 0.0) as sales_amt
        from web_sales
             join item on i_item_sk = ws_item_sk
             join date_dim on d_date_sk = ws_sold_date_sk
             left join web_returns on (ws_order_number = wr_order_number
                                       and ws_item_sk = wr_item_sk)
        where i_category = 'Books') sales_detail
  group by d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id)
select prev_yr.d_year as prev_year, curr_yr.d_year as year_,
       curr_yr.i_brand_id, curr_yr.i_class_id, curr_yr.i_category_id,
       curr_yr.i_manufact_id, prev_yr.sales_cnt as prev_yr_cnt,
       curr_yr.sales_cnt as curr_yr_cnt,
       curr_yr.sales_cnt - prev_yr.sales_cnt as sales_cnt_diff,
       curr_yr.sales_amt - prev_yr.sales_amt as sales_amt_diff
from all_sales curr_yr, all_sales prev_yr
where curr_yr.i_brand_id = prev_yr.i_brand_id
  and curr_yr.i_class_id = prev_yr.i_class_id
  and curr_yr.i_category_id = prev_yr.i_category_id
  and curr_yr.i_manufact_id = prev_yr.i_manufact_id
  and curr_yr.d_year = 2002 and prev_yr.d_year = 2002 - 1
  and cast(curr_yr.sales_cnt as double) / cast(prev_yr.sales_cnt as double)
        < 0.9
order by sales_cnt_diff, sales_amt_diff
limit 100
"""
